"""Sparsemax (sparse softmax) as a ``torch.autograd.Function``.

Port of ``probpose_code_tpu/ops/sparsemax.py:25-69``. Forward: the same
26-step bisection for the threshold tau on max-shifted logits, then an exact
renormalisation over the support, so the supports match the JAX version.
Backward: the gradient minus its mean over the support, zero elsewhere.
"""

from __future__ import annotations

import torch


def _sparsemax_forward(z: torch.Tensor, iters: int = 26) -> torch.Tensor:
    """Sparsemax over the last axis."""
    z_shift = z - z.max(dim=-1, keepdim=True).values
    lo = torch.full(z_shift.shape[:-1] + (1,), -1.0, dtype=z.dtype, device=z.device)
    hi = torch.zeros_like(lo)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        mass = torch.clamp(z_shift - mid, min=0.0).sum(dim=-1, keepdim=True)
        over = mass > 1.0
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    tau = (lo + hi) * 0.5
    p = torch.clamp(z_shift - tau, min=0.0)
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-12)


class _Sparsemax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        p = _sparsemax_forward(z)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        support = (p > 0).to(g.dtype)
        g_sum = (g * support).sum(dim=-1, keepdim=True)
        n_support = torch.clamp(support.sum(dim=-1, keepdim=True), min=1.0)
        return support * (g - g_sum / n_support)


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    """Project ``z`` onto the probability simplex along its last axis."""
    return _Sparsemax.apply(z)
