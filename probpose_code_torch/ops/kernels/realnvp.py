"""RLE's RealNVP flow as CUDA kernels, forward and backward.

Replaces no TPU kernel: the JAX package evaluates the flow with XLA
(``probpose_code_tpu/models/utils/realnvp.py:37-53``). ``RLELoss`` runs it on
every training step, where PyTorch makes some 150 small launches forward and
more backward; ``probpose_code_torch/csrc/realnvp.cu`` (which says what
bounds it) does it in one launch forward and two backward, on the twelve
nets' parameters packed into one buffer (``RealNVP.packed_parameters``).

``realnvp_log_prob`` takes a CPU tensor to the plain twin
(``RealNVP.log_prob_plain``, which torch autograd differentiates) and a
CUDA tensor to a ``torch.autograd.Function`` whose forward and backward are
the kernels; there is no fallback from one to the other. Each launching
function counts its calls in ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

PARAMETERS = 53_784  # 6 layers x 2 nets x (2 x 64 + 64 + 64 x 64 + 64 + 64 x 2 + 2)
ROWS = 32  # rows a block (``csrc/realnvp.cu``): the backward's partial sums come one slice a block

_SIGNATURES = {
    "realnvp_forward": [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p],
    "realnvp_backward": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p],
    "realnvp_parameter_count": ([], ctypes.c_int),
}


def _lib():
    lib = _build.load("realnvp", _SIGNATURES)
    if lib.realnvp_parameter_count() != PARAMETERS:
        raise RuntimeError("realnvp: the library's parameter layout is not the wrapper's")
    return lib


def _check(x: torch.Tensor, params: torch.Tensor) -> None:
    if x.device.type != "cuda" or params.device != x.device:
        raise ValueError(f"realnvp: expected CUDA tensors on one device, got {x.device} and {params.device}")
    if x.dtype != torch.float32 or params.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 2 \
            or params.shape != (PARAMETERS,):
        raise ValueError(f"realnvp: expected float32 (N, 2) inputs and ({PARAMETERS},) parameters; got {x.dtype} "
                         f"{tuple(x.shape)}, {params.dtype} {tuple(params.shape)}")


def realnvp_forward(x: torch.Tensor, params: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward launch on CUDA tensors: (N,) log-density and (N, 6, 2), z
    at each coupling layer's input (what the backward reads)."""
    _check(x, params)
    x, params = x.contiguous(), params.contiguous()
    n = x.shape[0]
    logp = torch.empty(n, dtype=torch.float32, device=x.device)
    zs = torch.empty(n, 6, 2, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.realnvp_forward(x.data_ptr(), params.data_ptr(), logp.data_ptr(), zs.data_ptr(), n,
                                   _build.stream_of(x))
    _build.check(lib, "realnvp", code)
    realnvp_forward.launches += 1
    return logp, zs


realnvp_forward.launches = 0


def realnvp_backward(grad: torch.Tensor, zs: torch.Tensor,
                     params: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward launches on CUDA tensors: the gradients of the inputs
    (N, 2) and of the packed parameters from the log-density's ``grad``."""
    n = zs.shape[0]
    _check(zs[:, 0], params)
    if grad.shape != (n,) or zs.shape != (n, 6, 2):
        raise ValueError(f"realnvp: gradient {tuple(grad.shape)} and saved z {tuple(zs.shape)} for {n} rows")
    grad, zs = grad.to(torch.float32).contiguous(), zs.contiguous()
    dx = torch.empty(n, 2, dtype=torch.float32, device=zs.device)
    dparams = torch.zeros(PARAMETERS, dtype=torch.float32, device=zs.device)
    partial = torch.empty((n + ROWS - 1) // ROWS, PARAMETERS, dtype=torch.float32, device=zs.device)
    lib = _lib()
    with torch.cuda.device(zs.device):
        code = lib.realnvp_backward(grad.data_ptr(), zs.data_ptr(), params.data_ptr(), dx.data_ptr(),
                                    partial.data_ptr(), dparams.data_ptr(), n, _build.stream_of(zs))
    _build.check(lib, "realnvp", code)
    realnvp_backward.launches += 1
    return dx, dparams


realnvp_backward.launches = 0


class _RealNVPLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, params):
        logp, zs = realnvp_forward(x, params)
        ctx.save_for_backward(zs, params)
        return logp

    @staticmethod
    def backward(ctx, grad):
        zs, params = ctx.saved_tensors
        dx, dparams = realnvp_backward(grad, zs, params)
        return dx, dparams


def realnvp_log_prob(x: torch.Tensor, flow) -> torch.Tensor:
    """``flow``'s (a ``models.utils.realnvp.RealNVP``) log-density of the
    (N, 2) residuals ``x``: the plain twin on a CPU tensor, the kernels on a
    CUDA one (the parameters packed by one ``torch.cat``, whose backward
    hands each its slice of the packed gradient)."""
    if x.device.type == "cpu":
        return flow.log_prob_plain(x)
    params = torch.cat([p.reshape(-1) for p in flow.packed_parameters()])
    return _RealNVPLogProb.apply(x, params)


def realnvp_flops(n: int) -> Tuple[int, int]:
    """The operations the forward and the backward need for ``n`` rows: a
    multiply-add counts two; per net and row 2 x 64 + 64 x 64 + 64 x 2
    multiply-adds forward, twice that backward (the gradients of the
    activations and of the weights); the backward's recomputation of the
    forward is not counted."""
    per_net = 2 * (2 * 64 + 64 * 64 + 64 * 2)
    return 12 * per_net * n, 2 * 12 * per_net * n


def realnvp_bytes(n: int) -> Tuple[int, int]:
    """The bytes the forward and the backward must move, each input read once
    and each output written once: x and the parameters -> log_prob and the
    saved z; the gradient, the saved z and the parameters -> dx and the
    parameters' gradient."""
    return 4 * (2 * n + PARAMETERS + n + 12 * n), 4 * (n + 12 * n + PARAMETERS + 2 * n + PARAMETERS)
