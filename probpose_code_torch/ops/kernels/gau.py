"""The gated attention unit's core in RTMPose's head, as CUDA kernels, and
its plain twin.

Replaces no TPU kernel: the JAX package's ``RTMCCBlock``
(``probpose_code_tpu/models/utils/rtmcc_block.py:88-108``) computes it with
XLA's einsums. The source is ``probpose_code_torch/csrc/gau.cu``, which says
what bounds it and what its design does. From the uv projection's output
``z`` (B, n, 2e + s), before the activation: ``u, v, base`` after the
activation, the query and key as ``base * gamma + beta``, the squared-ReLU
kernel ``relu(q k^T / sqrt(s))^2`` and ``u * (kernel @ v)``, (B, n, e).

``gau_attention`` takes a CPU tensor to the plain twin, which torch
autograd differentiates, and a CUDA tensor to a ``torch.autograd.Function``
whose forward and backward are the kernels; there is no fallback from one to
the other. The kernels take the options every shipped config sets (SiLU, no
relative position bias, no rotary encoding); on a CUDA tensor the others
raise. Each launching function counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_SIGNATURES = {
    "gau_forward": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "gau_backward": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "gau_chunks": [ctypes.c_int] * 2,
}
ACT_FNS = ("SiLU", "ReLU")


def _lib():
    return _build.load("gau", _SIGNATURES)


def rope(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Rotary position embedding over the token axis ``axis``; the last
    axis splits into the halves that rotate."""
    n = x.shape[axis]
    half = x.shape[-1] // 2
    position = torch.arange(n, dtype=torch.float32, device=x.device)
    freq_seq = -torch.arange(half, dtype=torch.float32, device=x.device) / float(half)
    inv_freq = 10000.0 ** -freq_seq
    sinusoid = position[:, None] * inv_freq[None]  # (n, half)
    shape = [1] * x.dim()
    shape[axis], shape[-1] = n, half
    sin, cos = torch.sin(sinusoid).reshape(shape), torch.cos(sinusoid).reshape(shape)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gau_attention_plain(z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, e: int, s: int,
                        act_fn: str = "SiLU", rel_bias: Optional[torch.Tensor] = None,
                        pos_enc: bool = False) -> torch.Tensor:
    """The GAU's core in PyTorch (``rtmcc_block.py:88-108``), with the
    options the kernels do not take: the (n, n) Toeplitz bias ``rel_bias``
    added to q k^T and the rotary encoding of the base (``pos_enc``)."""
    a = F.silu(z) if act_fn == "SiLU" else F.relu(z)
    u, v, base = torch.split(a, [e, e, s], dim=-1)
    base = base[..., None, :] * gamma[None, None] + beta[None, None]  # (B, n, 2, s)
    if pos_enc:
        base = rope(base, axis=1)
    q, k = base[..., 0, :], base[..., 1, :]
    qk = torch.einsum("bns,bms->bnm", q, k)
    if rel_bias is not None:
        qk = qk + rel_bias[None]
    kernel = torch.square(F.relu(qk / math.sqrt(s)))
    return u * torch.einsum("bnm,bme->bne", kernel, v)


def _check(z: torch.Tensor, e: int, s: int, **params: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(f"gau: unsupported device {z.device}")
    if z.dtype != torch.float32 or z.dim() != 3 or z.shape[-1] != 2 * e + s:
        raise ValueError(f"gau: expected float32 (B, n, {2 * e + s}) inputs, got {z.dtype} {tuple(z.shape)}")
    if e % 4 or s % 4:
        raise ValueError(f"gau: the kernels take widths e and s that are multiples of 4, got {e} and {s}")
    for name, t in params.items():
        if t.dtype != torch.float32 or t.shape != (2, s) or t.device != z.device:
            raise ValueError(f"gau: expected {name} float32 (2, {s}) on {z.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def gau_forward(z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, e: int,
                s: int) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The forward launch on CUDA tensors: returns the output (B, n, e) and
    what the backward reads: ``u`` and ``v`` after the activation (B, n,
    2e), q and k (B, n, s each), ``R = relu(q k^T / sqrt(s))`` and ``P =
    R^2`` (B, n, n), ``O = P v`` (B, n, e)."""
    _check(z, e, s, gamma=gamma, beta=beta)
    z, gamma, beta = z.contiguous(), gamma.contiguous(), beta.contiguous()
    B, n, _ = z.shape

    def empty(*shape):
        return torch.empty(*shape, device=z.device, dtype=torch.float32)

    saved = (empty(B, n, 2 * e), empty(B, n, s), empty(B, n, s), empty(B, n, n), empty(B, n, n), empty(B, n, e))
    out = empty(B, n, e)
    lib = _lib()
    with torch.cuda.device(z.device):
        code = lib.gau_forward(z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *(t.data_ptr() for t in saved),
                               out.data_ptr(), B, n, e, s, _build.stream_of(z))
    _build.check(lib, "gau", code)
    gau_forward.launches += 1
    return out, saved


gau_forward.launches = 0


def gau_backward(dout: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor, saved: Tuple[torch.Tensor, ...], e: int,
                 s: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward launch on CUDA tensors: the gradients of z, gamma and
    beta from the output's gradient ``dout`` (B, n, e) and what
    ``gau_forward`` kept (``saved``)."""
    _check(z, e, s, gamma=gamma)
    z, gamma = z.contiguous(), gamma.contiguous()
    dout = dout.to(torch.float32).contiguous()
    B, n, _ = z.shape
    if dout.shape != (B, n, e):
        raise ValueError(f"gau: expected a ({B}, {n}, {e}) gradient, got {tuple(dout.shape)}")
    lib = _lib()

    def empty(*shape):
        return torch.empty(*shape, device=z.device, dtype=torch.float32)

    dO, G, dQK, partial = empty(B, n, e), empty(B, n, n), empty(2, B, n, s), empty(lib.gau_chunks(B, n), 4, s)
    dz, dgamma, dbeta = torch.empty_like(z), torch.empty_like(gamma), torch.empty_like(gamma)
    with torch.cuda.device(z.device):
        code = lib.gau_backward(z.data_ptr(), gamma.data_ptr(), dout.data_ptr(), *(t.data_ptr() for t in saved),
                                dO.data_ptr(), G.data_ptr(), dQK.data_ptr(), partial.data_ptr(), dz.data_ptr(),
                                dgamma.data_ptr(), dbeta.data_ptr(), B, n, e, s, _build.stream_of(z))
    _build.check(lib, "gau", code)
    gau_backward.launches += 1
    return dz, dgamma, dbeta


gau_backward.launches = 0


class _GauAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, gamma, beta, e, s):
        out, saved = gau_forward(z, gamma, beta, e, s)
        ctx.save_for_backward(z, gamma, *saved)
        ctx.shape = (e, s)
        return out

    @staticmethod
    def backward(ctx, dout):
        z, gamma, *saved = ctx.saved_tensors
        dz, dgamma, dbeta = gau_backward(dout, z, gamma, tuple(saved), *ctx.shape)
        return dz, dgamma, dbeta, None, None


def gau_attention(z: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, e: int, s: int, act_fn: str = "SiLU",
                  rel_bias: Optional[torch.Tensor] = None, pos_enc: bool = False) -> torch.Tensor:
    """The GAU's core: the plain twin on a CPU tensor, the kernels on a CUDA
    one (which take SiLU only, and neither ``rel_bias`` nor ``pos_enc``)."""
    if act_fn not in ACT_FNS:
        raise ValueError(f"gau: act_fn {act_fn!r}")
    if z.device.type == "cpu":
        return gau_attention_plain(z, gamma, beta, e, s, act_fn, rel_bias, pos_enc)
    if act_fn != "SiLU" or rel_bias is not None or pos_enc:
        raise NotImplementedError("gau: the kernels take SiLU, no relative position bias and no rotary encoding")
    return _GauAttention.apply(z, gamma, beta, e, s)


def gau_flops(B: int, n: int, e: int, s: int) -> Tuple[int, int]:
    """The forward's and the backward's multiply-adds, counted as two
    operations each: q k^T and R^2 v; dO v^T, (R^2)^T dO, G k and G^T q."""
    return 2 * B * n * n * (s + e), 2 * B * n * n * (2 * e + 2 * s)
