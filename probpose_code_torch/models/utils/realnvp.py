"""RealNVP normalizing flow for RLE regression in PyTorch.

Port of ``probpose_code_tpu/models/utils/realnvp.py`` (``RealNVP``, ``:37-53``;
``_ScaleNet`` / ``_TransNet``, ``:21-34``) under mmpose's module names
(reference ``mmpose/models/utils/realnvp.py``): six coupling layers whose
masks alternate ``[0, 1]`` / ``[1, 0]``, each with a scale net ``s[i]`` and a
translation net ``t[i]`` (``Linear(2, 64)``, leaky ReLU, ``Linear(64, 64)``,
leaky ReLU, ``Linear(64, 2)``, and a tanh after the scale net's), walked in
reverse order from the residual ``x`` to ``z``:

    z = (1 - m) (z - t(m z)) exp(-s(m z)) + m z,   log_det -= sum(s)

and ``log_prob(x) = -|z|^2 / 2 - log(2 pi) + log_det`` under the standard
bivariate normal prior (the buffers ``loc`` and ``cov`` hold it, as mmpose's
``prior`` does; ``mask`` holds the masks). Initialisation: xavier-uniform
with gain 0.01 and zero biases (the JAX package's ``variance_scaling(1e-4,
"fan_avg", "uniform")``; mmpose keeps PyTorch's default biases).

``log_prob_plain`` is the plain twin of the flow kernel
(``ops/kernels/realnvp.py``, ``csrc/realnvp.cu``); ``RealNVP.forward`` takes
the twin on a CPU tensor and the kernel on a CUDA one.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from probpose_code_torch.ops.kernels.realnvp import realnvp_log_prob

HIDDEN = 64
LAYERS = 6
LOG_2PI = math.log(2 * math.pi)


def _net(scale: bool) -> nn.Sequential:
    layers = [nn.Linear(2, HIDDEN), nn.LeakyReLU(0.01), nn.Linear(HIDDEN, HIDDEN), nn.LeakyReLU(0.01),
              nn.Linear(HIDDEN, 2)]
    return nn.Sequential(*layers, nn.Tanh()) if scale else nn.Sequential(*layers)


def _mlp(x: torch.Tensor, net: nn.Sequential) -> torch.Tensor:
    """The net's three linear layers with leaky ReLU between (no tanh)."""
    x = F.leaky_relu(F.linear(x, net[0].weight, net[0].bias), 0.01)
    x = F.leaky_relu(F.linear(x, net[2].weight, net[2].bias), 0.01)
    return F.linear(x, net[4].weight, net[4].bias)


class RealNVP(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("loc", torch.zeros(2))
        self.register_buffer("cov", torch.eye(2))
        self.register_buffer("mask", torch.tensor([[0, 1], [1, 0]] * (LAYERS // 2), dtype=torch.float32))
        self.s = nn.ModuleList([_net(scale=True) for _ in range(LAYERS)])
        self.t = nn.ModuleList([_net(scale=False) for _ in range(LAYERS)])
        self.init_weights()

    def init_weights(self) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, gain=0.01)
                nn.init.zeros_(m.bias)

    def packed_parameters(self):
        """The twelve nets' parameters in the kernel's order: layer by layer,
        the scale net then the translation net, each ``Linear``'s weight
        (out, in) then its bias (53,784 floats in all)."""
        for i in range(LAYERS):
            for net in (self.s[i], self.t[i]):
                for j in (0, 2, 4):
                    yield net[j].weight
                    yield net[j].bias

    def log_prob_plain(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 2) residuals -> (N,) log-density, in PyTorch ops."""
        log_det = x.new_zeros(x.shape[0])
        z = x
        for i in reversed(range(LAYERS)):
            m = self.mask[i]
            z_ = m * z
            s = torch.tanh(_mlp(z_, self.s[i])) * (1 - m)
            t = _mlp(z_, self.t[i]) * (1 - m)
            z = (1 - m) * (z - t) * torch.exp(-s) + z_
            log_det = log_det - s.sum(dim=1)
        return -0.5 * (z ** 2).sum(dim=1) - LOG_2PI + log_det

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 2) residuals -> (N,) log-density: the plain twin on a CPU
        tensor, the flow kernel on a CUDA one."""
        return realnvp_log_prob(x, self)
