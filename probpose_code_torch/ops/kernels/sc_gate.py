"""SCNet's self-calibration gate as CUDA kernels, and its plain twin.

Replaces no TPU kernel: the JAX package computes the gate with XLA's resize
and elementwise operations (``probpose_code_tpu/models/backbones/classic.py:
330-333``). By the 2% rule (``PERF.md`` §6) it became a kernel: forward and
backward of ``k3 * sigmoid(x + up(k2))`` each in one pass over the maps
(``probpose_code_torch/csrc/sc_gate.cu``, which says what bounds them).

``self_calibration`` takes CPU tensors to the plain twin (which torch
autograd differentiates) and CUDA tensors to a ``torch.autograd.Function``
whose forward and backward are the kernels; there is no fallback from one to
the other. Each launching function counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "sc_gate_forward": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "sc_gate_backward": [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _lib():
    return _build.load("sc_gate", _SIGNATURES)


def self_calibration_plain(x: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """SCNet's gate in PyTorch: ``k3 * sigmoid(x + up(k2))``, ``up`` the
    bilinear resize of the pooled branch ``k2`` (B, C, h, w) to the size of
    ``x`` and ``k3`` (B, C, H, W), half-pixel centres (the JAX package's
    ``jax.image.resize``: an upsample, where its antialiasing does nothing)."""
    up = F.interpolate(k2, size=x.shape[2:], mode="bilinear", align_corners=False, antialias=False)
    return k3 * torch.sigmoid(x + up)


def _check(x: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"sc_gate: unsupported device {x.device}")
    if any(t.dtype != torch.float32 for t in (x, k2, k3)) or x.dim() != 4 or x.shape != k3.shape \
            or k2.shape[:2] != x.shape[:2] or not (0 < k2.shape[2] <= x.shape[2] and 0 < k2.shape[3] <= x.shape[3]):
        raise ValueError(f"sc_gate: expected float32 (B, C, H, W) x and k3 and (B, C, h, w) k2 with h <= H, w <= W; "
                         f"got {x.dtype} {tuple(x.shape)}, {k2.dtype} {tuple(k2.shape)}, {k3.dtype} {tuple(k3.shape)}")


def _sizes(x: torch.Tensor, k2: torch.Tensor):
    B, C, H, W = x.shape
    return B * C, H, W, k2.shape[2], k2.shape[3]


def sc_gate_forward(x: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """The forward launch on CUDA tensors: the gated ``k3``."""
    _check(x, k2, k3)
    x, k2, k3 = x.contiguous(), k2.contiguous(), k3.contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.sc_gate_forward(x.data_ptr(), k2.data_ptr(), k3.data_ptr(), out.data_ptr(), *_sizes(x, k2),
                                   _build.stream_of(x))
    _build.check(lib, "sc_gate", code)
    sc_gate_forward.launches += 1
    return out


sc_gate_forward.launches = 0


def sc_gate_backward(dy: torch.Tensor, x: torch.Tensor, k2: torch.Tensor,
                     k3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward launch on CUDA tensors: the gradients of ``x``, ``k2`` and
    ``k3`` from the output's ``dy``."""
    _check(x, k2, k3)
    if dy.shape != x.shape:
        raise ValueError(f"sc_gate: the gradient's shape {tuple(dy.shape)} is not the output's {tuple(x.shape)}")
    dy, x, k2, k3 = dy.to(torch.float32).contiguous(), x.contiguous(), k2.contiguous(), k3.contiguous()
    dx, dk2, dk3 = torch.empty_like(x), torch.empty_like(k2), torch.empty_like(k3)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.sc_gate_backward(dy.data_ptr(), x.data_ptr(), k2.data_ptr(), k3.data_ptr(), dx.data_ptr(),
                                    dk2.data_ptr(), dk3.data_ptr(), *_sizes(x, k2), _build.stream_of(x))
    _build.check(lib, "sc_gate", code)
    sc_gate_backward.launches += 1
    return dx, dk2, dk3


sc_gate_backward.launches = 0


class _SelfCalibration(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k2, k3):
        ctx.save_for_backward(x, k2, k3)
        return sc_gate_forward(x, k2, k3)

    @staticmethod
    def backward(ctx, dy):
        return sc_gate_backward(dy, *ctx.saved_tensors)


def self_calibration(x: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor) -> torch.Tensor:
    """SCNet's gate: the plain twin on CPU tensors, the kernels on CUDA ones."""
    if x.device.type == "cpu":
        return self_calibration_plain(x, k2, k3)
    return _SelfCalibration.apply(x, k2, k3)


def sc_gate_bytes(elements: int, small: int):
    """The bytes the forward and the backward must move, each input read once
    and each output written once: x, k3 and k2 -> out; dy, x, k3 and k2 ->
    dx, dk3 and dk2 (``elements`` the maps' size, ``small`` k2's)."""
    return 4 * (3 * elements + small), 4 * (5 * elements + 2 * small)
