"""K3: the differentiable pre-norm ViT layer for training, as CUDA kernels,
and its plain twin.

Replaces the TPU kernel ``probpose_code_tpu/ops/pallas/vit_layer_train.py:
vit_layer_train`` (``_fwd_kernel``, ``_bwd_mlp_kernel``,
``_bwd_attn_kernel``). The source is
``probpose_code_torch/csrc/vit_layer_train.cu``.

What bounds it on the H100: operations. At the flagship shape (64 images of
N = 192 tokens, C = 384, 12 heads, F = 1536) the forward is 47.1 GFLOP and
the least a backward can do is twice that, 94.2 GFLOP: 0.048 and 0.095 ms at
989 TFLOP/s, against about 0.1 GB of inputs and outputs. What the design
does about it: in bf16 every product runs on the tensor cores
(``csrc/tc_tiles.cuh``: the forward's products, dx = dY W^T and the weight
gradients as mma.sync GEMMs with fused epilogues; the attention forward and
its query-side and key-side backward as mma.sync tiles). The forward keeps
what the backward reads, the softmax row sums included, so only the
attention probabilities are recomputed. The weight gradients are products
over the B*N rows split into a few partials summed in a fixed order, with no
atomics, so the result does not depend on the order of blocks and two runs
give the same bits. In f32 the products run on the FMA units: the f32 bars
(2e-4 forward, 5e-4 gradients) rule out single-pass TF32. Both take every
shape that ``fits`` admits with heads up to 432 wide, and raise on a wider
head.

``vit_layer_train`` takes a CPU tensor to the plain twin, which torch
autograd differentiates, and a CUDA tensor to a ``torch.autograd.Function``
whose forward and backward are the kernels. The q-scale fold stays outside
the Function as tracked ops, as in the JAX wrapper, so the gradient's
un-scaling falls out of autograd.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .vit_layer import _DTYPE_CODE, _fold_q_scale, _layer_plain, fits

_N_WEIGHTS = 12
_SIGNATURES = {
    "vit_layer_train_forward": [ctypes.c_int] + [ctypes.c_void_p] * 24
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    "vit_layer_train_backward": [ctypes.c_int] + [ctypes.c_void_p] * 32
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    "vit_layer_train_workspace_bytes": [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "vit_layer_train_shape_error": ([ctypes.c_int] * 2, ctypes.c_char_p),
}
# the operands the backward reads: ln1_scale, w_qkv, w_proj, ln2_scale, w_fc1, w_fc2
_BWD_WEIGHTS = (0, 2, 4, 6, 8, 10)


def _lib():
    return _build.load("vit_layer_train", _SIGNATURES)


def vit_layer_train_plain(
    x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj,
    ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
    drop_mask1=None, drop_mask2=None,
    *, num_heads: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``_fwd_kernel`` in plain torch with its casts (K1's math with the
    per-image masks m1, m2 on the two branches, tanh-GELU); torch autograd
    gives its backward. Weights are (in, out), not yet q-scaled."""
    w_qkv, b_qkv = _fold_q_scale(w_qkv, b_qkv, x.shape[-1] // num_heads)
    return _layer_plain(
        x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj, ln2_scale, ln2_bias,
        w_fc1, b_fc1, w_fc2, b_fc2, num_heads=num_heads, eps=eps, approximate_gelu=True,
        dtype=dtype, drop_mask1=drop_mask1, drop_mask2=drop_mask2,
    )


def _operands(params, dtype):
    """The weights in ``dtype``, norms and biases in f32, all contiguous."""
    return tuple(
        (p.to(dtype) if p.dim() == 2 else p.float()).contiguous() for p in params
    )


def _check(x: torch.Tensor, tensors, dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"vit_layer_train: unsupported device {x.device}")
    if dtype not in _DTYPE_CODE or x.dtype != dtype:
        raise TypeError(f"vit_layer_train: x is {x.dtype}, compute type {dtype}; both must be f32 or bf16")
    if any(t.device != x.device for t in tensors):
        raise ValueError("vit_layer_train: all tensors must be on x's device")
    if not x.is_contiguous() or not all(t.is_contiguous() for t in tensors):
        raise ValueError("vit_layer_train: x, the masks and the operands must be contiguous")


def vit_layer_train_forward(
    x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor, ops: Tuple[torch.Tensor, ...],
    *, num_heads: int, eps: float,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The forward kernels: x (B, N, C), masks (B,) f32, the twelve operands of
    ``_operands`` (q-scale folded). Returns out (B, N, C) in x's type and the
    tensors the backward reads: xn1, qkv, attn, x1 (f32), xn2, hpre (f32),
    hidden and the softmax row sums (B*N, H) (f32)."""
    B, N, C = x.shape
    F_ = ops[8].shape[-1]
    _check(x, (m1, m2, *ops), x.dtype)
    lib = _lib()
    error = lib.vit_layer_train_shape_error(_DTYPE_CODE[x.dtype], C // num_heads)
    if error is not None:
        raise ValueError(f"vit_layer_train: shape {(B, N, C)} with {num_heads} heads: {error.decode()}")
    M, dt, dev = B * N, x.dtype, x.device
    saved = (
        torch.empty(M, C, dtype=dt, device=dev),            # xn1
        torch.empty(M, 3 * C, dtype=dt, device=dev),        # qkv
        torch.empty(M, C, dtype=dt, device=dev),            # attn
        torch.empty(M, C, dtype=torch.float32, device=dev),  # x1
        torch.empty(M, C, dtype=dt, device=dev),            # xn2
        torch.empty(M, F_, dtype=torch.float32, device=dev),  # hpre
        torch.empty(M, F_, dtype=dt, device=dev),           # hidden
        torch.empty(M, num_heads, dtype=torch.float32, device=dev),  # softmax row sums
    )
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        code = lib.vit_layer_train_forward(
            _DTYPE_CODE[dt], _build.ptr(x), _build.ptr(m1), _build.ptr(m2),
            *[_build.ptr(t) for t in ops], *[_build.ptr(t) for t in saved], _build.ptr(out),
            B, N, C, num_heads, F_, ctypes.c_float(eps), _build.stream_of(x),
        )
    _build.check(lib, "vit_layer_train", code)
    vit_layer_train_forward.launches += 1
    return out, saved


vit_layer_train_forward.launches = 0


def vit_layer_train_backward(
    g: torch.Tensor, x: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
    ops: Tuple[torch.Tensor, ...], saved: Tuple[torch.Tensor, ...], *, num_heads: int, eps: float,
) -> Tuple[torch.Tensor, ...]:
    """The backward kernels: g, the gradient of the forward's output, and what
    the forward returned. Returns dx in x's type and the twelve operands'
    gradients in f32, in ``_operands`` order."""
    B, N, C = x.shape
    F_ = ops[8].shape[-1]
    g = g.contiguous()
    _check(x, (g, m1, m2, *ops, *saved), x.dtype)
    if g.dtype != x.dtype:
        raise TypeError(f"vit_layer_train: gradient is {g.dtype}, x is {x.dtype}")
    lib = _lib()
    dt, dev = x.dtype, x.device
    nbytes = torch.zeros(1, dtype=torch.int64)
    lib.vit_layer_train_workspace_bytes(_DTYPE_CODE[dt], B, N, C, num_heads, F_, _build.ptr(nbytes))
    work = torch.empty(int(nbytes.item()), dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    grads = tuple(torch.empty(p.shape, dtype=torch.float32, device=dev) for p in ops)
    with torch.cuda.device(dev):
        code = lib.vit_layer_train_backward(
            _DTYPE_CODE[dt], _build.ptr(g), _build.ptr(x), _build.ptr(m1), _build.ptr(m2),
            *[_build.ptr(ops[i]) for i in _BWD_WEIGHTS], *[_build.ptr(t) for t in saved],
            _build.ptr(dx), *[_build.ptr(t) for t in grads], _build.ptr(work),
            B, N, C, num_heads, F_, ctypes.c_float(eps), _build.stream_of(x),
        )
    _build.check(lib, "vit_layer_train", code)
    vit_layer_train_backward.launches += 1
    return (dx,) + grads


vit_layer_train_backward.launches = 0


class _VitLayerTrain(torch.autograd.Function):
    """The K3 kernels as one differentiable operation on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, m1, m2, num_heads, eps, *params):
        ops = _operands(params, x.dtype)
        out, saved = vit_layer_train_forward(x, m1, m2, ops, num_heads=num_heads, eps=eps)
        ctx.save_for_backward(x, m1, m2, *ops, *saved)
        ctx.num_heads, ctx.eps = num_heads, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, m1, m2, *rest = ctx.saved_tensors
        ops, saved = tuple(rest[:_N_WEIGHTS]), tuple(rest[_N_WEIGHTS:])
        dx, *grads = vit_layer_train_backward(
            g, x, m1, m2, ops, saved, num_heads=ctx.num_heads, eps=ctx.eps,
        )
        return (dx, None, None, None, None, *grads)


def vit_layer_train(
    x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj,
    ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
    drop_mask1=None, drop_mask2=None,
    *, num_heads: int, eps: float = 1e-6, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The K3 wrapper. x: (B, N, C) in ``dtype``; weights (in, out) as in the
    JAX package; ``drop_mask{1,2}``: per-image stochastic-depth multipliers
    (B,) of 0 or 1/keep, or None for none. Returns (B, N, C) in x's type,
    differentiable in x and all twelve parameters. Tanh-GELU only. Raises
    where the TPU kernel's shape rule fails (the caller checks ``fits``)."""
    B, N, C = x.shape
    if not fits(N, C, num_heads) or tuple(w_qkv.shape) != (C, 3 * C):
        raise ValueError(f"vit_layer_train: shape {(B, N, C)} with {num_heads} heads breaks the K3 rule")
    if x.device.type == "cpu":
        return vit_layer_train_plain(
            x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj, ln2_scale, ln2_bias,
            w_fc1, b_fc1, w_fc2, b_fc2, drop_mask1, drop_mask2,
            num_heads=num_heads, eps=eps, dtype=dtype,
        )
    if x.device.type != "cuda":
        raise ValueError(f"vit_layer_train: unsupported device {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"vit_layer_train: x is {x.dtype}, compute type {dtype}")
    w_qkv, b_qkv = _fold_q_scale(w_qkv, b_qkv, C // num_heads)
    ones = torch.ones(B, dtype=torch.float32, device=x.device)
    m1 = ones if drop_mask1 is None else drop_mask1.float().contiguous()
    m2 = ones if drop_mask2 is None else drop_mask2.float().contiguous()
    return _VitLayerTrain.apply(
        x.contiguous(), m1, m2, num_heads, eps,
        ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj,
        ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
    )

