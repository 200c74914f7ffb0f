"""K4: the attention core of a ViT layer, as a CUDA kernel, and its plain twins.

Replaces the TPU kernel ``probpose_code_tpu/ops/pallas/attention.py:
fused_attention`` (``_mha_kernel``). The source is
``probpose_code_torch/csrc/attention.cu``.

What bounds it on the H100: at the ViTPose-B training shape (64 images of
N = 192 tokens, 12 heads, d = 64, f32) QK^T and PV are 7.25 GFLOP against
151 MB of inputs and outputs: 0.044 ms at the 165 TFLOP/s of f32-accurate
products that 3xTF32 leaves of the tensor cores' 495 TF32, against 0.045 ms
at 3.35 TB/s. What the design does about it: both products run on the
tensor cores (``csrc/tc_tiles.cuh``: bf16 as mma.sync m16n8k16, f32 as
3xTF32 m16n8k8, whose error of about 2^-22 a product keeps the f32 bar);
q, k and v are read in place from the qkv projection's strided
(B, N, 3, h, d) view and the output is written as (B, N, C), so no
transpose reaches device memory; at N <= 192 with d <= 64, and in f32 with
d <= 96 (ViTPose-H's 80), each score is computed once and the key row stays
in registers, elsewhere K and V stream through shared memory in key chunks,
so the N x N scores never reach device memory. Heads up to 896 wide.
``attention_occupancy`` reads what the instance chosen for a shape holds on
an SM (registers, spills, shared memory, resident blocks).

``fused_attention`` is a ``torch.autograd.Function``. Its forward is the
kernel on a CUDA tensor and ``fused_attention_plain`` on a CPU tensor; it
never gives way from one to the other. Its backward follows the JAX
package's custom VJP (``attention.py:78-85``): it recomputes
``xla_attention`` (``:32-36``) from the saved q, k and v under torch
autograd. That recompute is the JAX package's own backward, not a fallback;
there is no backward kernel, as there is none on the TPU. Without autograd
(``torch.inference_mode``, ``torch.no_grad``) only the forward kernel runs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SIGNATURES = {
    "attention_forward": [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    "attention_shape_error": ([ctypes.c_int] * 2, ctypes.c_char_p),
    "attention_occupancy": [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    return _build.load("attention", _SIGNATURES)


def xla_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """``xla_attention`` (``attention.py:32-36``): (B, N, h, d) in and out.
    The scores come out of the product in q's type (bf16 inputs give bf16
    scores); the softmax is in f32 and its result is cast back to q's type."""
    s = torch.einsum("bqhd,bkhd->bhqk", q * torch.tensor(scale, dtype=q.dtype), k)
    a = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, v)


def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The kernel's twin, with ``_mha_kernel``'s casts (``attention.py:39-51,
    60``): q * scale in q's type, scores accumulated and kept in f32, a
    max-shifted softmax in f32, p rounded to v's type, p v accumulated in f32
    and cast to q's type. (B, N, h, d) in and out."""
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The K4 launch: q, k, v (B, N, h, d) CUDA tensors of one type (f32 or
    bf16), d contiguous, any other strides; returns (B, N, h, d) contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"attention: q, k, v must share one (B, N, h, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; all must be f32 or all bf16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k and v must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention: the head dimension d must be contiguous")
    B, N, H, D = q.shape
    lib = _lib()
    error = lib.attention_shape_error(_DTYPE_CODE[q.dtype], D)
    if error is not None:
        raise ValueError(f"attention: head width {D}: {error.decode()}")
    out = torch.empty(B, N, H, D, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*[s for t in (q, k, v) for s in t.stride()[:3]])
    with torch.cuda.device(q.device):
        code = lib.attention_forward(
            _DTYPE_CODE[q.dtype], _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            strides, B, N, H, D, ctypes.c_float(scale), _build.stream_of(q),
        )
    _build.check(lib, "attention", code)
    attention_kernel.launches += 1
    return out


attention_kernel.launches = 0


def attention_occupancy(dtype: torch.dtype, N: int, D: int, shift: bool = True) -> dict:
    """What the instance that the attention engine launches for N keys of
    heads D wide holds on an SM of the current card: registers and local
    memory (spills) a thread, dynamic shared memory and threads a block,
    resident blocks and warps an SM. ``shift``: K4's instance (a max-shifted
    softmax), else K1's. Reads the card's function attributes; launches
    nothing."""
    lib = _lib()
    out = (ctypes.c_int * 5)()
    _build.check(lib, "attention", lib.attention_occupancy(_DTYPE_CODE[dtype], int(shift), N, D, out))
    regs, local, smem, threads, blocks = out
    return dict(registers=regs, local_bytes=local, smem_bytes=smem, threads=threads, blocks_per_sm=blocks,
                warps_per_sm=blocks * threads // 32)


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale)
    return attention_kernel(q, k, v, scale)


class _FusedAttention(torch.autograd.Function):
    """The kernel's forward; the backward recomputes ``xla_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = xla_attention_plain(q_, k_, v_, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), g)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The K4 wrapper: multi-head attention of (B, N, h, d) q, k, v with a
    Python-float ``scale``; returns (B, N, h, d), differentiable in q, k and
    v. A CUDA tensor goes to the kernel, a CPU tensor to its plain twin."""
    return _FusedAttention.apply(q, k, v, float(scale))


def attention_flops(B: int, N: int, H: int, D: int) -> int:
    """Operations of QK^T and PV."""
    return 4 * B * H * N * N * D
