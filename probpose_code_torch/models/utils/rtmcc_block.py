"""The gated attention unit (GAU) of RTMPose's head, in PyTorch.

Port of ``probpose_code_tpu/models/utils/rtmcc_block.py``: ``rope``
(``:20``), ``ScaleNorm`` (``:37``) and ``RTMCCBlock`` (``:51``) with its
relative position bias (``:70``). ScaleNorm -> one projection to ``u``,
``v`` and a shared base -> per-branch (gamma, beta) query and key from the
base (rotary position encoding with ``pos_enc``) -> the squared-ReLU kernel
``relu(q k^T / sqrt(s))^2`` (plus the Toeplitz bias ``w[j - i + n - 1]``
with ``use_rel_bias``) -> ``u * (kernel @ v)`` -> output projection, and a
residual with a learnt per-channel scale where the widths agree. Names are
mmpose's (``ln.g``, ``uv``, ``gamma``, ``beta``, ``w``, ``o``,
``res_scale.scale``), the names the JAX package's ``_convert_rtmcc_head``
(``engine/checkpoint.py:541``) reads. f32; dropout and drop-path (0 in
every shipped config) and cross-attention are not ported. Everything
between the two projections is ``ops/kernels/gau.py:gau_attention``: on
the card its kernels (``csrc/gau.cu``), forward and backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from probpose_code_torch.ops.kernels.gau import gau_attention, rope  # noqa: F401 (rope: this module's name too)


class ScaleNorm(nn.Module):
    """``x * g / max(||x|| d^-0.5, eps)`` over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale = dim ** -0.5
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale
        return x / torch.clamp(norm, min=self.eps) * self.g


class Scale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class RTMCCBlock(nn.Module):
    def __init__(self, num_token: int, in_token_dims: int, out_token_dims: int, expansion_factor: int = 2,
                 s: int = 128, eps: float = 1e-5, dropout_rate: float = 0.0, drop_path: float = 0.0,
                 attn_type: str = "self-attn", act_fn: str = "SiLU", bias: bool = False,
                 use_rel_bias: bool = True, pos_enc: bool = False):
        super().__init__()
        if attn_type != "self-attn" or dropout_rate or drop_path:
            raise NotImplementedError("RTMCCBlock: cross-attention, dropout and drop-path are not ported yet")
        if act_fn not in ("SiLU", "ReLU"):
            raise ValueError(f"RTMCCBlock: act_fn {act_fn!r}")
        self.s, self.act_fn, self.pos_enc = s, act_fn, pos_enc
        self.e = int(in_token_dims * expansion_factor)
        self.ln = ScaleNorm(in_token_dims, eps=eps)
        self.uv = nn.Linear(in_token_dims, 2 * self.e + s, bias=bias)
        self.gamma = nn.Parameter(torch.rand(2, s))
        self.beta = nn.Parameter(torch.zeros(2, s))
        self.w = nn.Parameter(torch.rand(2 * num_token - 1)) if use_rel_bias else None
        self.o = nn.Linear(self.e, out_token_dims, bias=bias)
        self.res_scale = Scale(in_token_dims) if in_token_dims == out_token_dims else None

    def rel_pos_bias(self, seq_len: int) -> torch.Tensor:
        """(n, n) Toeplitz bias ``w[j - i + n - 1]``."""
        idx = torch.arange(seq_len, device=self.w.device)
        return self.w[idx[None, :] - idx[:, None] + seq_len - 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n, in_token_dims) tokens -> (B, n, out_token_dims)."""
        uv = self.uv(self.ln(x))
        rel_bias = None if self.w is None else self.rel_pos_bias(x.shape[1])
        out = self.o(gau_attention(uv, self.gamma, self.beta, self.e, self.s, self.act_fn, rel_bias, self.pos_enc))
        return out if self.res_scale is None else self.res_scale(x) + out
