"""AdamW with layer-wise lr decay, plain Adam, gradient clipping and the lr schedules.

Port of ``probpose_code_tpu/engine/optim.py``: the layer-decay scale
(``:31-61``), the weight-decay mask (``:64-73``), ``build_schedule``
(``:94-154``) and ``build_optimizer`` (``:167-219``). The update is optax's
chain, in its order, written out in torch:

    clip by global norm -> Adam moments -> + weight_decay * p (masked)
    -> * layer scale -> * -lr(k)

and, for ``type="Adam"`` (the HRNet recipes), the same without the mask
(``weight_decay`` applies to every parameter, ``:194-197``) or a layer
scale.

with ``lr(k)`` for update k counted from 0, as optax counts. Where torch's
own pieces differ from optax they are not used: ``clip_grad_norm_`` divides
by ``norm + 1e-6`` (optax scales by ``max_norm / norm`` only when the norm
exceeds ``max_norm``), and a parameter without a gradient is updated as with
a zero gradient (its moments decay and its weight decay applies), as optax
updates every leaf.

Parameter names are the port's (mmpretrain's): ``backbone.patch_embed.*``
and ``backbone.pos_embed`` are layer 0, ``backbone.layers.{i}.*`` layer
i + 1, everything else (the head, and the final norm ``backbone.ln1``)
layer num_layers + 1.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_LAYER = re.compile(r"^backbone\.layers\.(\d+)\.")


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer index of a parameter for layer-wise lr decay."""
    if name.startswith(("backbone.patch_embed.", "backbone.pos_embed", "backbone.cls_token")):
        return 0
    m = _LAYER.match(name)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def lr_scale(name: str, num_layers: int, decay_rate: float) -> float:
    """``decay_rate ** (num_layers + 2 - layer_id - 1)``."""
    return decay_rate ** (num_layers + 2 - vit_layer_id(name, num_layers) - 1)


def decays(name: str, param: torch.Tensor) -> bool:
    """Weight decay applies to tensors of two or more dims, except biases and
    ``pos_embed``."""
    return param.dim() > 1 and not name.endswith("bias") and "pos_embed" not in name


# --------------------------------------------------------------------------
# Schedules: mmengine param_scheduler configs composed into lr(step)
# --------------------------------------------------------------------------


def build_schedule(
    scheduler_cfgs: Sequence[Dict[str, Any]], base_lr: float, steps_per_epoch: int, max_epochs: int,
) -> Callable[[int], float]:
    """LinearLR, MultiStepLR, ConstantLR, CosineAnnealingLR,
    QuadraticWarmupLR and ExponentialLR, their factors multiplied.
    ``by_epoch=True`` ranges are epochs (turned into iterations). The result
    is an f32 value, as the JAX schedule computes it."""
    total_steps = steps_per_epoch * max_epochs
    cfgs = [dict(c) for c in scheduler_cfgs]
    for c in cfgs:
        if c["type"] not in _SCHEDULES:
            raise ValueError(f"Unsupported scheduler type {c['type']}")

    def lr_fn(step: int) -> float:
        step_f = torch.tensor(float(step), dtype=torch.float32)
        lr = torch.tensor(base_lr, dtype=torch.float32)
        for cfg in cfgs:
            unit = steps_per_epoch if cfg.get("by_epoch", True) else 1
            begin = cfg.get("begin", 0) * unit
            end = cfg.get("end", max_epochs if cfg.get("by_epoch", True) else total_steps) * unit
            lr = lr * _SCHEDULES[cfg["type"]](cfg, step_f, begin, end, unit, base_lr)
        return float(lr)

    return lr_fn


def _linear(cfg, step, begin, end, unit, base_lr):
    start, stop = cfg.get("start_factor", 1.0 / 3), cfg.get("end_factor", 1.0)
    frac = torch.clamp((step - begin) / max(end - begin, 1), 0.0, 1.0)
    return torch.where(step < begin, torch.tensor(start), start + (stop - start) * frac)


def _quadratic_warmup(cfg, step, begin, end, unit, base_lr):
    frac = torch.clamp((step - begin) / max(end - begin, 1), 0.0, 1.0)
    return torch.where(step < end, frac ** 2, torch.tensor(1.0))


def _multistep(cfg, step, begin, end, unit, base_lr):
    gamma = cfg.get("gamma", 0.1)
    n_passed = sum(int(step >= m * unit) for m in cfg.get("milestones", []))
    active = bool(step >= begin)  # in or after [begin, end)
    return torch.tensor(gamma ** n_passed if active else 1.0, dtype=torch.float32)


def _constant(cfg, step, begin, end, unit, base_lr):
    inside = bool((step >= begin) & (step < end))
    return torch.tensor(cfg.get("factor", 1.0 / 3) if inside else 1.0, dtype=torch.float32)


def _cosine(cfg, step, begin, end, unit, base_lr):
    eta_min = cfg.get("eta_min", 0.0)
    frac = torch.clamp((step - begin) / max(end - begin, 1), 0.0, 1.0)
    factor = eta_min / base_lr + (1 - eta_min / base_lr) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step >= begin, factor, torch.tensor(1.0))


def _exponential(cfg, step, begin, end, unit, base_lr):
    epochs_passed = torch.floor((step - begin) / max(unit, 1))
    return torch.where(step >= begin, cfg.get("gamma", 0.9) ** epochs_passed, torch.tensor(1.0))


_SCHEDULES = dict(
    LinearLR=_linear, QuadraticWarmupLR=_quadratic_warmup, MultiStepLR=_multistep,
    ConstantLR=_constant, CosineAnnealingLR=_cosine, ExponentialLR=_exponential,
)


# --------------------------------------------------------------------------
# The optimizer
# --------------------------------------------------------------------------


@dataclass
class AdamState:
    """optax's ``scale_by_adam`` state: the update count and both moments."""

    count: int = 0
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)


class LayerDecayAdamW:
    """AdamW over named parameters, grouped by (lr scale, weight decay);
    ``decay_mask`` picks the parameters that weight decay applies to
    (``decays``; every one for plain Adam). Its state lives in an
    ``AdamState`` the caller keeps (``init``), so that the train state
    holds it."""

    eps = 1e-8  # optax.scale_by_adam's

    def __init__(
        self, named_params: Iterable[Tuple[str, torch.Tensor]], lr_fn: Callable[[int], float], *,
        betas=(0.9, 0.999), weight_decay: float = 0.0, max_norm: Optional[float] = None,
        num_layers: int = 12, decay_rate: Optional[float] = None,
        decay_mask: Callable[[str, torch.Tensor], bool] = decays,
    ):
        self.names, self.params = [], []
        for n, p in named_params:
            if p.requires_grad:
                self.names.append(n)
                self.params.append(p)
        self.lr_fn = lr_fn
        self.b1, self.b2 = betas
        self.max_norm = max_norm
        groups: Dict[Tuple[float, float], List[int]] = {}
        for i, (n, p) in enumerate(zip(self.names, self.params)):
            scale = 1.0 if decay_rate is None else lr_scale(n, num_layers, decay_rate)
            groups.setdefault((scale, weight_decay if decay_mask(n, p) else 0.0), []).append(i)
        self.groups = [dict(lr_scale=s, weight_decay=wd, index=idx) for (s, wd), idx in groups.items()]

    def init(self) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in self.params], [torch.zeros_like(p) for p in self.params])

    def group_lrs(self, step: int) -> List[float]:
        """The lr each group's update ``step`` applies (schedule x layer scale)."""
        lr = self.lr_fn(step)
        return [lr * g["lr_scale"] for g in self.groups]

    def grads(self) -> List[torch.Tensor]:
        """Each parameter's gradient, zeros where autograd left none."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, state: AdamState, grads: List[torch.Tensor]) -> None:
        """Apply one update to the parameters, in place, and advance ``state``."""
        if self.max_norm:
            norm = global_norm(grads)
            clip = norm >= self.max_norm  # optax keeps updates whose norm is below max_norm
            grads = [torch.where(clip, g / norm * self.max_norm, g) for g in grads]
        k = state.count + 1
        torch._foreach_lerp_(state.mu, grads, 1.0 - self.b1)  # mu = b1 * mu + (1 - b1) * g
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(grads, grads), alpha=1.0 - self.b2)
        lr = self.lr_fn(state.count)
        bc1, bc2 = 1.0 - self.b1 ** k, 1.0 - self.b2 ** k
        for g in self.groups:
            idx = g["index"]
            params = [self.params[i] for i in idx]
            mu_hat = torch._foreach_div([state.mu[i] for i in idx], bc1)
            den = torch._foreach_sqrt(torch._foreach_div([state.nu[i] for i in idx], bc2))
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(mu_hat, den)
            if g["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=g["weight_decay"])
            torch._foreach_mul_(upd, g["lr_scale"])
            torch._foreach_add_(params, upd, alpha=-lr)
        state.count = k


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The l2 norm of all elements together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def build_optimizer(
    model,
    optim_wrapper: Dict[str, Any],
    param_scheduler: Optional[List[Dict[str, Any]]] = None,
    steps_per_epoch: int = 1000,
    max_epochs: int = 210,
) -> Tuple[LayerDecayAdamW, Callable[[int], float]]:
    """The optimizer of a reference-style ``optim_wrapper`` config over a
    PoseModel's parameters. Returns (optimizer, lr_fn); lr_fn is for
    logging. AdamW (the ViT recipes') and Adam (the HRNet recipes')."""
    opt_cfg = dict(optim_wrapper.get("optimizer", {}))
    opt_type = opt_cfg.pop("type", "AdamW")
    if opt_type not in ("AdamW", "Adam"):
        raise NotImplementedError(f"optimizer {opt_type} is not ported yet (AdamW and Adam are)")
    if int(optim_wrapper.get("accumulative_counts", 1) or 1) > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    base_lr = opt_cfg.pop("lr", 1e-3)
    if param_scheduler:
        lr_fn = build_schedule(param_scheduler, base_lr, steps_per_epoch, max_epochs)
    else:
        lr_fn = lambda step: float(torch.tensor(base_lr, dtype=torch.float32))  # noqa: E731
    paramwise = optim_wrapper.get("paramwise_cfg") or {}
    layer_decay = (optim_wrapper.get("constructor") == "LayerDecayOptimWrapperConstructor"
                   or "layer_decay_rate" in paramwise)
    clip_cfg = optim_wrapper.get("clip_grad") or {}
    optimizer = LayerDecayAdamW(
        model.module.named_parameters(), lr_fn, betas=tuple(opt_cfg.pop("betas", (0.9, 0.999))),
        weight_decay=opt_cfg.pop("weight_decay", 0.0), max_norm=clip_cfg.get("max_norm"),
        num_layers=paramwise.get("num_layers", 12),
        decay_rate=paramwise.get("layer_decay_rate", 0.75) if layer_decay else None,
        decay_mask=decays if opt_type == "AdamW" else (lambda name, param: True),
    )
    return optimizer, lr_fn
