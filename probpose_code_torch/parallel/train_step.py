"""The training step on one device.

Port of ``probpose_code_tpu/parallel/train_step.py`` without its mesh: the
JAX step is one jitted program; here it runs eagerly (no ``torch.compile``),
and the parameters, the BatchNorm statistics and the optimizer state are
updated in place. Data parallelism across cards comes later.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from probpose_code_torch.engine.optim import AdamState, LayerDecayAdamW, global_norm


@dataclass
class TrainState:
    """step: updates applied; model: the PoseModel whose module holds the
    parameters and BatchNorm statistics; opt_state: the optimizer's moments."""

    step: int
    model: object
    opt_state: AdamState

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return self.model.batch_stats()


def create_train_state(model, optimizer: LayerDecayAdamW) -> TrainState:
    return TrainState(step=0, model=model, opt_state=optimizer.init())


def make_train_step(model, optimizer: LayerDecayAdamW) -> Callable:
    """(state, batch, generator) -> (state, metrics). ``generator`` draws the
    stochastic-depth masks; the caller owns and seeds it. ``metrics`` holds
    the loss dict, ``loss`` (the sum of the ``loss_*`` terms) and
    ``grad_norm``, the global norm of the raw gradients, all as tensors on the
    model's device."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        for p in optimizer.params:
            p.grad = None
        total, (losses, _) = model.loss_fn(batch, generator)
        total.backward()
        grads = optimizer.grads()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update(state.opt_state, grads)
        return TrainState(step=state.step + 1, model=state.model, opt_state=state.opt_state), metrics

    return step
