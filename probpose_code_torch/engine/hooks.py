"""Training hooks of the runner.

The port's own copy of ``probpose_code_tpu/engine/hooks.py``: the ``Hook``
protocol (``:33-57``), ``ExpMomentumEMA`` and its mmengine-schema front
``EMAHook`` (``:60-150``; reference ``ema_hook.py:14``), and
``SyncBuffersHook`` / ``SyncNormHook`` (``:327-340``), which have nothing to
synchronize on one card, as on the TPU, and RTMPose's ``PipelineSwitchHook``
(``:188-206``). The other mode-switch hooks and the visualization, bad-case
and profiler hooks come with the families and tools that use them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from probpose_code_torch.datasets.base_dataset import Compose
from probpose_code_torch.registry import HOOKS


class Hook:
    """The runner calls each of these on every hook of ``custom_hooks``."""

    def before_run(self, runner):
        pass

    def before_train_epoch(self, runner, epoch: int):
        pass

    def after_train_iter(self, runner, step: int, metrics: Dict[str, Any]):
        pass

    def after_val_epoch(self, runner, metrics: Dict[str, float]):
        pass

    def before_eval(self, runner):
        """Called before validation and checkpoint writing: weight-averaging
        hooks swap their averaged weights into the live model here (the
        reference EMAHook validates and saves the EMA weights)."""

    def after_eval(self, runner):
        """Restore the live training weights after ``before_eval``."""

    def before_save_checkpoint(self, runner) -> Dict[str, Any]:
        """Entries to store in the checkpoint beside the weights."""
        return {}

    def after_load_checkpoint(self, runner, checkpoint: Dict[str, Any]) -> None:
        """Called when training resumes from ``checkpoint``, its weights
        already in the model."""

    def after_run(self, runner):
        pass


@HOOKS.register_module()
class ExpMomentumEMA(Hook):
    """EMA of the parameters with exponentially warmed momentum
    ``m_t = (1 - m) * exp(-(1 + t) / gamma) + m``; ``gamma=None`` keeps the
    momentum constant. ``update_buffers`` also averages the BatchNorm
    running statistics. The averaged copy lives on the model's device; the
    swap for eval copies it into the live tensors in place (and back), so
    the optimizer keeps its parameters."""

    def __init__(self, momentum: float = 0.0002, gamma: Optional[int] = 2000, update_buffers: bool = False,
                 begin_iter: int = 0, begin_epoch: int = 0):
        self.momentum = momentum
        self.gamma = gamma
        self.update_buffers = update_buffers
        self.begin_iter = begin_iter
        self.begin_epoch = begin_epoch
        self.ema_params: Optional[List[torch.Tensor]] = None
        self.ema_buffers: Optional[List[torch.Tensor]] = None
        self._backup = None  # the live (params, buffers) while the EMA is swapped in

    def _tracked(self, runner):
        module = runner.model.module
        params = [p.data for p in module.parameters()]
        bufs = list(runner.model.batch_stats().values()) if self.update_buffers else None
        return params, bufs

    @torch.no_grad()
    def after_train_iter(self, runner, step: int, metrics):
        params, bufs = self._tracked(runner)
        # until the begin point the EMA is re-seeded from the live weights
        # every step, so that at the start point it equals them
        before_begin = step < self.begin_iter or getattr(runner, "epoch", 0) < self.begin_epoch
        if self.ema_params is None or before_begin:
            self.ema_params = [p.clone() for p in params]
            self.ema_buffers = [b.clone() for b in bufs] if bufs is not None else None
            return
        m = self.momentum
        if self.gamma:
            m = (1 - self.momentum) * math.exp(-(1 + step) / self.gamma) + self.momentum
        for ema, live in ((self.ema_params, params), (self.ema_buffers or [], bufs or [])):
            for e, p in zip(ema, live):
                e.mul_(1 - m).add_(p * m)

    @torch.no_grad()
    def _copy_into(self, runner, params, bufs):
        live_params, live_bufs = self._tracked(runner)
        for dst, src in zip(live_params, params):
            dst.copy_(src)
        for dst, src in zip(live_bufs or [], bufs or []):
            dst.copy_(src)

    def before_eval(self, runner):
        if self.ema_params is None or self._backup is not None:
            return
        params, bufs = self._tracked(runner)
        self._backup = ([p.clone() for p in params], [b.clone() for b in bufs] if bufs is not None else None)
        self._copy_into(runner, self.ema_params, self.ema_buffers)

    def after_eval(self, runner):
        if self._backup is None:
            return
        backup, self._backup = self._backup, None
        self._copy_into(runner, *backup)

    def _names(self, runner):
        params = [n for n, _ in runner.model.module.named_parameters()]
        return params, list(runner.model.batch_stats()) if self.update_buffers else []

    def before_save_checkpoint(self, runner) -> Dict[str, Any]:
        """The runner saves with the average swapped in (``before_eval``), so
        the file's weights are the averaged ones, as mmengine's EMAHook saves
        them; the live weights go beside them as ``ema_state_dict``, from
        which a resumed run continues."""
        if self._backup is None:
            return {}
        params, bufs = self._names(runner)
        live = [t.detach().cpu() for t in (*self._backup[0], *(self._backup[1] or []))]
        return dict(ema_state_dict=dict(zip(params + bufs, live)))

    @torch.no_grad()
    def after_load_checkpoint(self, runner, checkpoint: Dict[str, Any]) -> None:
        """The file's (averaged) weights become the average again, and its
        ``ema_state_dict`` the live weights."""
        if "ema_state_dict" not in checkpoint:
            return
        self.ema_params, self.ema_buffers = (None if t is None else [x.clone() for x in t]
                                             for t in self._tracked(runner))
        params, bufs = self._names(runner)
        live = checkpoint["ema_state_dict"]
        self._copy_into(runner, [live[n] for n in params], [live[n] for n in bufs])


@HOOKS.register_module()
class EMAHook(ExpMomentumEMA):
    """The reference recipes' schema (``dict(type='EMAHook',
    ema_type='ExpMomentumEMA', momentum=0.0002, update_buffers=True,
    priority=49)``): ``ema_type`` 'ExpMomentumEMA' warms the momentum, any
    other keeps it constant."""

    def __init__(self, ema_type: str = "ExpMomentumEMA", momentum: float = 0.0002, gamma: int = 2000,
                 update_buffers: bool = False, priority: int = 49, strict_load: bool = False, begin_iter: int = 0,
                 begin_epoch: int = 0, **_ignored):
        super().__init__(momentum=momentum, gamma=gamma if ema_type == "ExpMomentumEMA" else None,
                         update_buffers=update_buffers, begin_iter=begin_iter, begin_epoch=begin_epoch)
        self.priority = priority


@HOOKS.register_module()
class SyncBuffersHook(Hook):
    """Nothing to do on one card: the BatchNorm statistics are the batch's
    (reference: all-reduces buffers across ranks after each epoch)."""


@HOOKS.register_module()
class SyncNormHook(Hook):
    """Nothing to do on one card (reference ``sync_norm_hook.py:22``
    all-reduces norm-layer states across ranks before val)."""

    def __init__(self, priority: int = 48, **_ignored):
        self.priority = priority


@HOOKS.register_module()
class PipelineSwitchHook(Hook):
    """Swap the train dataset's pipeline for ``switch_pipeline`` before
    epoch ``switch_epoch`` (the mmdet schema every RTMPose recipe writes:
    ``switch_epoch=max_epochs - stage2_num_epochs``); a run resumed past
    that epoch switches before its first. The train loader's workers are
    kept across epochs, each with its own copy of the dataset, so the hook
    also ends them: the loader starts new ones, which copy the switched
    dataset, when the epoch's iteration begins."""

    def __init__(self, switch_epoch: int, switch_pipeline: Optional[list] = None):
        self.switch_epoch = int(switch_epoch)
        self.switch_pipeline = switch_pipeline
        self._switched = False

    def before_train_epoch(self, runner, epoch: int):
        if self._switched or epoch < self.switch_epoch:
            return
        self._switched = True
        if self.switch_pipeline and runner.train_loader is not None:
            runner.train_loader.dataset.pipeline = Compose(self.switch_pipeline)
            runner.train_loader.close()
            runner.log(f"pipeline switch at epoch {epoch}: stage2 train pipeline active")
