"""The squeeze-and-excite layer with its passes over the maps as CUDA kernels, and its plain twin.

Replaces no TPU kernel: the JAX package computes the layer with XLA's mean,
Dense layers and product (``probpose_code_tpu/models/backbones/classic.py``,
``vipnas.py``). By the 2% rule (``PERF.md`` §6) it became a kernel: the
squeeze (each plane's mean), the excitation (the two 1x1 convolutions on
the pooled (B, C) vectors and the gate) and the scale (each plane times its
gate), forward and backward, are the kernels of ``probpose_code_torch/csrc/
se_layer.cu``, which says what bounds them: three launches forward, four
backward.

``se_layer`` takes CPU tensors to the plain twin (which torch autograd
differentiates) and CUDA tensors to a ``torch.autograd.Function`` whose
forward and backward launch the kernels; there is no fallback from one to
the other. Each launching function counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_SIGNATURES = {
    "se_reduce": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "se_scale": [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "se_excite_forward": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "se_excite_backward": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "se_weight_grad": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _lib():
    return _build.load("se_layer", _SIGNATURES)


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp((x + 3) / 6, 0.0, 1.0)


def excitation(pooled: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
               hard: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gate of each plane from the pooled (B, C) vectors: the first 1x1
    convolution (``w1`` (mid, C), ``b1``), ReLU, the second (``w2`` (C, mid),
    ``b2``), sigmoid (or the hard sigmoid). Returns (the first product z1,
    the second z2, the gate)."""
    z1 = pooled @ w1.t() + b1
    z2 = torch.relu(z1) @ w2.t() + b2
    return z1, z2, hsigmoid(z2) if hard else torch.sigmoid(z2)


def se_layer_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   hard: bool = False) -> torch.Tensor:
    """The layer in PyTorch: ``x * gate`` with the gate of ``excitation`` on
    the spatial mean of ``x`` (B, C, H, W)."""
    gate = excitation(x.mean(dim=(2, 3)), w1, b1, w2, b2, hard)[2]
    return x * gate[:, :, None, None]


def _check(x: torch.Tensor, *vectors: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"se_layer: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4 or any(
            v.dtype != torch.float32 or v.shape != x.shape[:2] for v in vectors):
        raise ValueError(f"se_layer: expected a float32 (B, C, H, W) map and float32 (B, C) vectors; got "
                         f"{x.dtype} {tuple(x.shape)}, {[(v.dtype, tuple(v.shape)) for v in vectors]}")


def _check_weights(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> None:
    C = x.shape[1]
    if any(t.device != x.device or t.dtype != torch.float32 for t in (w1, b1, w2, b2)) or w1.dim() != 2 \
            or w1.shape[1] != C or b1.shape != w1.shape[:1] or w2.shape != (C, w1.shape[0]) or b2.shape != (C,):
        raise ValueError(f"se_layer: expected float32 (M, {C}), (M,), ({C}, M) and ({C},) weights on {x.device}; got "
                         f"{[(t.dtype, tuple(t.shape), str(t.device)) for t in (w1, b1, w2, b2)]}")


def _call(entry: str, ref: torch.Tensor, *args) -> None:
    lib = _lib()
    with torch.cuda.device(ref.device):
        code = getattr(lib, entry)(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
                                   _build.stream_of(ref))
    _build.check(lib, "se_layer", code)


def _reduce(a: torch.Tensor, b: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Each (B, C) plane's ``scale * sum(a)`` or ``scale * sum(a * b)``."""
    B, C, H, W = a.shape
    out = torch.empty(B, C, dtype=torch.float32, device=a.device)
    _call("se_reduce", a, a, b, out, B * C, H * W, scale)
    return out


def _scale(a: torch.Tensor, gate: torch.Tensor, shift: Optional[torch.Tensor]) -> torch.Tensor:
    """Each plane of ``a`` times its ``gate`` (plus its ``shift``)."""
    B, C, H, W = a.shape
    out = torch.empty_like(a)
    _call("se_scale", a, a, gate, shift, out, B * C, H * W)
    return out


def _excite(pooled, w1, b1, w2, b2, hard):
    """(z1, z2, gate) of ``excitation`` by one launch a sample."""
    (B, C), M = pooled.shape, w1.shape[0]
    z1 = pooled.new_empty(B, M)
    z2, gate = pooled.new_empty(B, C), pooled.new_empty(B, C)
    _call("se_excite_forward", pooled, pooled, w1, b1, w2, b2, z1, z2, gate, B, C, M, int(hard))
    return z1, z2, gate


def _excite_grad(dgate, z1, z2, gate, w1, w2, inv_p, hard):
    """(dz1, dz2, the mean's gradient times ``inv_p``) by one launch a sample."""
    (B, C), M = dgate.shape, w1.shape[0]
    dz1, dz2, dmean = dgate.new_empty(B, M), dgate.new_empty(B, C), dgate.new_empty(B, C)
    _call("se_excite_backward", dgate, dgate, z1, z2, gate, w1, w2, dz1, dz2, dmean, B, C, M, inv_p, int(hard))
    return dz1, dz2, dmean


def _weight_grad(dz1, dz2, pooled, z1):
    """The gradients of w1, b1, w2 and b2, each a sum over the batch."""
    (B, M), C = dz1.shape, dz2.shape[1]
    dw1, db1, dw2, db2 = dz1.new_empty(M, C), dz1.new_empty(M), dz1.new_empty(C, M), dz1.new_empty(C)
    _call("se_weight_grad", dz1, dz1, dz2, pooled, z1, dw1, db1, dw2, db2, B, C, M)
    return dw1, db1, dw2, db2


def se_layer_forward(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     hard: bool) -> Tuple[torch.Tensor, ...]:
    """The forward on a CUDA map, three launches: the squeeze (each plane's
    mean), the excitation (z1, z2 and the gate of each sample), the scale
    (each plane times its gate). Returns (y, pooled, z1, z2, gate)."""
    _check(x)
    _check_weights(x, w1, b1, w2, b2)
    x = x.contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    pooled = _reduce(x, None, 1.0 / (x.shape[2] * x.shape[3]))
    z1, z2, gate = _excite(pooled, w1, b1, w2, b2, hard)
    y = _scale(x, gate, None)
    se_layer_forward.launches += 1
    return y, pooled, z1, z2, gate


se_layer_forward.launches = 0


def se_layer_backward(dy: torch.Tensor, x: torch.Tensor, pooled: torch.Tensor, z1: torch.Tensor, z2: torch.Tensor,
                      gate: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, hard: bool) -> Tuple[torch.Tensor, ...]:
    """The backward on CUDA tensors, four launches: the gate's gradient (each
    plane's ``dy . x``), the excitation's (dz2, dz1 and the mean's gradient
    of each sample), the map's gradient ``dy * gate + dmean / (H W)`` in one
    pass, and the weights' and biases'. Returns the gradients of x, w1, b1,
    w2 and b2."""
    _check(x, pooled, gate)
    if dy.shape != x.shape:
        raise ValueError(f"se_layer: the gradient's shape {tuple(dy.shape)} is not the output's {tuple(x.shape)}")
    dy, x = dy.to(x.dtype).contiguous(), x.contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    dgate = _reduce(dy, x, 1.0)
    dz1, dz2, dmean = _excite_grad(dgate, z1, z2, gate, w1, w2, 1.0 / (x.shape[2] * x.shape[3]), hard)
    dx = _scale(dy, gate, dmean)
    se_layer_backward.launches += 1
    return (dx, *_weight_grad(dz1, dz2, pooled, z1))


se_layer_backward.launches = 0


class _SELayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, hard):
        y, pooled, z1, z2, gate = se_layer_forward(x, w1, b1, w2, b2, hard)
        ctx.hard = hard
        ctx.save_for_backward(x, pooled, z1, z2, gate, w1, w2)
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*se_layer_backward(dy, *ctx.saved_tensors, ctx.hard), None)


def se_layer(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
             hard: bool = False) -> torch.Tensor:
    """The squeeze-and-excite layer: the plain twin on CPU tensors, the
    kernels on CUDA ones. ``w1`` (mid, C) and ``w2`` (C, mid) are its 1x1
    convolutions' weights as matrices."""
    if x.device.type == "cpu":
        return se_layer_plain(x, w1, b1, w2, b2, hard)
    return _SELayer.apply(x, w1, b1, w2, b2, hard)


def se_layer_bytes(elements: int, vectors: int):
    """The bytes the forward and the backward must move, each input read once
    and each output written once: x -> y; dy and x -> dx (``elements`` the
    map's size; ``vectors`` the (B, C) gate's, read or written once more)."""
    return 4 * (2 * elements + vectors), 4 * (3 * elements + vectors)
