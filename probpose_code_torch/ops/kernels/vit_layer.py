"""K1: one pre-norm ViT layer for serving, as a CUDA kernel, and its plain twin.

Replaces the TPU kernel ``probpose_code_tpu/ops/pallas/vit_layer.py:
vit_layer_fused`` (``_layer_kernel``). The source is
``probpose_code_torch/csrc/vit_layer.cu``.

What bounds it on the H100: operations. At the flagship shape (128 images of
N = 192 tokens, C = 384, 12 heads, F = 1536) one layer is 94.2 GFLOP against
41 MB of inputs and outputs in bf16: 95 us at 989 TFLOP/s against 12 us at
3.35 TB/s; at the ViTPose-B predict shape (C = 768, F = 3072, f32) it is
362.4 GFLOP: 2.2 ms at the 165 TFLOP/s of f32-accurate products that 3xTF32
leaves of the tensor cores' 495 TF32. What the design does about it: every
product runs on the tensor cores (``csrc/tc_tiles.cuh``: mma.sync from
ldmatrix fragments fed by a cp.async ring) with f32 accumulation and a fused
epilogue (bias, the f32 residual, GELU): bf16 operands as they are, f32
operands as 3xTF32 (each split into two TF32 parts, three products: about
2^-22 relative error a product, where the f32 bar of 1e-4 rules out
single-pass TF32's 2^-11). The attention never writes the N x N scores to
device memory (at N <= 192 with heads up to 64 wide, and in f32 up to 96,
it computes each score once and keeps the key row in registers; elsewhere
it makes two passes over key chunks). A whole layer does not fit one block
(x alone is 295 KB in f32 for four images), so the intermediates round-trip
through device memory.

Both instances take every shape that ``fits`` admits, with heads up to 896
wide; ``vit_layer_prepared`` raises on a wider head (there is no other
path).

``vit_layer_prepared`` takes a CPU tensor to the plain twin and a CUDA tensor
to the kernel; it never falls back from one to the other. ``vit_layer`` is
the same layer for weights that have not been through ``prepare_weights``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "vit_layer_forward": [ctypes.c_int] + [ctypes.c_void_p] * 19
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "vit_layer_shape_error": ([ctypes.c_int] * 2, ctypes.c_char_p),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fits(tokens: int, dim: int, num_heads: int) -> bool:
    """The TPU kernel's shape rule (``vit_layer.py:131-138``): the layer runs
    through K1 exactly when it holds."""
    if dim % num_heads:
        return False
    return (dim // num_heads) % 8 == 0 and tokens % 8 == 0


def _fold_q_scale(w_qkv: torch.Tensor, b_qkv: torch.Tensor, head_dim: int):
    """Fold the attention's 1/sqrt(D) into the first C columns of W_qkv and
    b_qkv, in f32 (``vit_layer.py:140-147``)."""
    C = w_qkv.shape[0]
    col = torch.ones(3 * C, dtype=torch.float32, device=w_qkv.device)
    col[:C] = head_dim ** -0.5
    return w_qkv.float() * col, b_qkv.float() * col


def _ln_f32(xf, scale, bias, eps):
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # operands already rounded to the compute type; products summed in f32
    return a.float() @ b.float()


def prepare_weights(
    ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj,
    ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
    *, num_heads: int, dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, ...]:
    """The layer's operands as the kernel reads them: the q-scale folded into
    W_qkv and b_qkv, the (in, out) weights contiguous in ``dtype``, the norms
    and biases contiguous in f32. A model does this once per set of weights,
    not on every call."""
    w_qkv, b_qkv = _fold_q_scale(w_qkv, b_qkv, w_qkv.shape[0] // num_heads)

    def wt(t):
        return t.to(dtype).contiguous()

    def f32(t):
        return t.float().contiguous()

    return (
        f32(ln1_scale), f32(ln1_bias), wt(w_qkv), f32(b_qkv), wt(w_proj), f32(b_proj),
        f32(ln2_scale), f32(ln2_bias), wt(w_fc1), f32(b_fc1), wt(w_fc2), f32(b_fc2),
    )


def _layer_plain(
    x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj,
    ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
    *, num_heads: int, eps: float, approximate_gelu: bool, dtype: torch.dtype,
    drop_mask1=None, drop_mask2=None,
) -> torch.Tensor:
    # the weights as ``prepare_weights`` leaves them: q-scale folded. With
    # per-image masks (B,), each branch is scaled before its residual add,
    # as in K3: x1 = x + m1 * (attn @ W_proj + b_proj)
    B, N, C = x.shape
    H = num_heads
    D = C // H
    xf = x.float().reshape(B * N, C)
    xn = _ln_f32(xf, ln1_scale.float(), ln1_bias.float(), eps)
    qkv = (_mm(xn.to(dtype), w_qkv.to(dtype)) + b_qkv).to(dtype)

    def heads(t):
        return t.reshape(B, N, H, D).permute(0, 2, 1, 3).float()

    q, k, v = heads(qkv[:, :C]), heads(qkv[:, C:2 * C]), heads(qkv[:, 2 * C:])
    p = torch.exp(torch.clamp(q @ k.transpose(-1, -2), max=80.0))
    p = p / p.sum(dim=-1, keepdim=True)
    o = (p.to(dtype).float() @ v).to(dtype)
    attn = o.permute(0, 2, 1, 3).reshape(B * N, C)

    h1 = _mm(attn, w_proj.to(dtype))
    if drop_mask1 is None:
        x1 = xf + h1 + b_proj.float()
    else:
        x1 = xf + drop_mask1.float().repeat_interleave(N)[:, None] * (h1 + b_proj.float())
    xn2 = _ln_f32(x1, ln2_scale.float(), ln2_bias.float(), eps)
    hh = _mm(xn2.to(dtype), w_fc1.to(dtype)) + b_fc1.float()
    hh = F.gelu(hh, approximate="tanh" if approximate_gelu else "none")
    y = _mm(hh.to(dtype), w_fc2.to(dtype))
    if drop_mask2 is None:
        out = x1 + y + b_fc2.float()
    else:
        out = x1 + drop_mask2.float().repeat_interleave(N)[:, None] * (y + b_fc2.float())
    return out.to(x.dtype).reshape(B, N, C)


def vit_layer_plain(
    x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj,
    ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
    *, num_heads: int, eps: float = 1e-6, approximate_gelu: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``_layer_kernel`` in plain torch, with its casts: operands in
    ``dtype``, f32 accumulation, x1 kept in f32, softmax as
    ``exp(min(s, 80)) / sum`` without a max shift. Weights are (in, out)."""
    w_qkv, b_qkv = _fold_q_scale(w_qkv, b_qkv, x.shape[-1] // num_heads)
    return _layer_plain(
        x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj, ln2_scale, ln2_bias,
        w_fc1, b_fc1, w_fc2, b_fc2, num_heads=num_heads, eps=eps,
        approximate_gelu=approximate_gelu, dtype=dtype,
    )


def _lib():
    return _build.load("vit_layer", _SIGNATURES)


def vit_layer(
    x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj,
    ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2,
    *, num_heads: int, eps: float = 1e-6, approximate_gelu: bool = True,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """One fused serving layer. x: (B, N, C); weights (in, out) as in the
    JAX package; returns (B, N, C) in x's type. Prepares the weights on every
    call: a model keeps ``prepare_weights``' result and calls
    ``vit_layer_prepared``."""
    weights = prepare_weights(
        ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj, ln2_scale, ln2_bias,
        w_fc1, b_fc1, w_fc2, b_fc2, num_heads=num_heads, dtype=dtype,
    )
    return vit_layer_prepared(
        x, weights, num_heads=num_heads, eps=eps, approximate_gelu=approximate_gelu, dtype=dtype,
    )


def vit_layer_prepared(
    x: torch.Tensor, weights: Tuple[torch.Tensor, ...], *, num_heads: int, eps: float = 1e-6,
    approximate_gelu: bool = True, dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The K1 wrapper: x (B, N, C) and the output of ``prepare_weights``."""
    B, N, C = x.shape
    ln1_scale, ln1_bias, w_qkv, b_qkv, w_proj, b_proj, ln2_scale, ln2_bias, w_fc1, b_fc1, w_fc2, b_fc2 = weights
    F_ = w_fc1.shape[-1]
    if not fits(N, C, num_heads) or tuple(w_qkv.shape) != (C, 3 * C):
        raise ValueError(f"vit_layer: shape {(B, N, C)} with {num_heads} heads breaks the K1 rule")
    if tuple(w_proj.shape) != (C, C) or tuple(w_fc1.shape) != (C, F_) or tuple(w_fc2.shape) != (F_, C):
        raise ValueError("vit_layer: weight shapes do not match (in, out) layout")
    if x.device.type == "cpu":
        return _layer_plain(
            x, *weights, num_heads=num_heads, eps=eps, approximate_gelu=approximate_gelu, dtype=dtype,
        )
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in weights)):
        # the kernel fills its output through ctypes: the result would carry
        # no gradient, so the call is refused rather than silently detached
        raise RuntimeError("vit_layer: K1 has no backward; a layer under autograd goes through "
                           "ops.kernels.vit_layer_train (K3)")
    if x.device.type != "cuda":
        raise ValueError(f"vit_layer: unsupported device {x.device}")
    if dtype not in _DTYPE_CODE or x.dtype != dtype:
        raise TypeError(f"vit_layer: x is {x.dtype}, compute type {dtype}; both must be f32 or bf16")
    if not x.is_contiguous() or not all(t.is_contiguous() for t in weights):
        raise ValueError("vit_layer: x and the prepared weights must be contiguous")
    if any(t.dtype != (dtype if t.dim() == 2 else torch.float32) for t in weights):
        raise TypeError(f"vit_layer: weights must be {dtype}, norms and biases f32 (see prepare_weights)")
    if any(t.device != x.device for t in weights):
        raise ValueError("vit_layer: all tensors must be on x's device")
    lib = _lib()
    error = lib.vit_layer_shape_error(_DTYPE_CODE[dtype], C // num_heads)
    if error is not None:
        raise ValueError(f"vit_layer: shape {(B, N, C)} with {num_heads} heads: {error.decode()}")

    M = B * N
    xn = torch.empty(M, C, dtype=dtype, device=x.device)
    qkv = torch.empty(M, 3 * C, dtype=dtype, device=x.device)
    attn = torch.empty(M, C, dtype=dtype, device=x.device)
    x1 = torch.empty(M, C, dtype=torch.float32, device=x.device)
    hidden = torch.empty(M, F_, dtype=dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.vit_layer_forward(
            _DTYPE_CODE[dtype], _build.ptr(x), *[_build.ptr(t) for t in weights],
            *[_build.ptr(t) for t in (xn, qkv, attn, x1, hidden, out)],
            B, N, C, num_heads, F_, ctypes.c_float(eps), int(not approximate_gelu),
            _build.stream_of(x),
        )
    _build.check(lib, "vit_layer", code)
    vit_layer_prepared.launches += 1
    return out


vit_layer_prepared.launches = 0


def layer_flops(B: int, N: int, C: int, F_: int) -> int:
    """Operations of one layer: the four products plus QK^T and PV."""
    return 2 * B * N * C * (4 * C + 2 * F_) + 4 * B * N * N * C
