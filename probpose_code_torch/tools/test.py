"""Evaluate a pose model on the config's test set.

The port's counterpart of the JAX package's ``tools/test.py``:

    python -m probpose_code_torch.tools.test CONFIG [CHECKPOINT]
        [--cfg-options K=V ...] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises when CUDA
is absent. A checkpoint (``.pth``: a state dict, or a runner file with
``state_dict`` and ``meta``) is loaded by ``engine.checkpoint.
load_checkpoint``; without one the weights are random (seed 0). It prints
one ``name: value`` line per metric.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from probpose_code_torch.config import Config, parse_cfg_option
from probpose_code_torch.datasets.loader import stop_workers
from probpose_code_torch.engine.checkpoint import load_checkpoint
from probpose_code_torch.engine.runner import Runner


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Test a pose estimator")
    parser.add_argument("config")
    parser.add_argument("checkpoint", nargs="?", default=None)
    parser.add_argument("--cfg-options", nargs="+", default=[], metavar="K=V")
    parser.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    return parser.parse_args(argv)


def build_runner(cfg: Config, device=None) -> Runner:
    """The runner that evaluates ``cfg``: its test set and evaluator as the
    val ones, and none of its ``custom_hooks``, which act only in training."""
    if "test_dataloader" in cfg:
        cfg.val_dataloader = cfg.test_dataloader
    if "test_evaluator" in cfg:
        cfg.val_evaluator = cfg.test_evaluator
    cfg.custom_hooks = []
    return Runner.from_cfg(cfg, device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(dict(parse_cfg_option(kv) for kv in args.cfg_options))
    runner = build_runner(cfg, device=args.device)
    if args.checkpoint:
        load_checkpoint(runner.model, args.checkpoint)
    try:
        metrics = runner.val()
    finally:
        stop_workers()
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()
