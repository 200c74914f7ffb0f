"""Train a pose model from a config file.

The port's counterpart of the JAX package's ``tools/train.py``:

    python -m probpose_code_torch.tools.train CONFIG [--work-dir DIR]
        [--resume [CKPT]] [--amp] [--no-validate] [--auto-scale-lr]
        [--cfg-options K=V ...] [--seed N] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises when CUDA
is absent. ``--resume`` alone continues from the work dir's newest
``epoch_N.pth``, ``--resume CKPT`` from that file. ``--no-validate`` trains
without validation. ``--auto-scale-lr`` scales the lr by the batch size over
the config's ``auto_scale_lr.base_batch_size``, as the JAX ``merge_args``
does. The multi-process ``--launcher`` is not ported. The loader's workers
and their fork server are stopped before it returns.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Optional, Sequence

from probpose_code_torch.config import Config, parse_cfg_option
from probpose_code_torch.datasets.loader import stop_workers
from probpose_code_torch.engine.runner import Runner


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="Train a pose estimator")
    parser.add_argument("config", help="train config file path")
    parser.add_argument("--work-dir", help="the dir to save logs and checkpoints")
    parser.add_argument("--resume", nargs="?", const="auto", default=None,
                        help="resume from a checkpoint ('auto', or no value: the newest in the work dir)")
    parser.add_argument("--amp", action="store_true", help="use bfloat16 compute")
    parser.add_argument("--no-validate", action="store_true", help="train without validation")
    parser.add_argument("--auto-scale-lr", action="store_true")
    parser.add_argument("--cfg-options", nargs="+", default=[], metavar="K=V")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="the card unless 'cpu' is given")
    return parser.parse_args(argv)


def merge_args(cfg: Config, args) -> Config:
    """The JAX package's ``merge_args`` (``tools/train.py:44-65``)."""
    if args.work_dir:
        cfg.work_dir = args.work_dir
    elif "work_dir" not in cfg:
        cfg.work_dir = osp.join("work_dirs", osp.splitext(osp.basename(args.config))[0])
    if args.resume is not None:
        cfg.resume = True
    if args.amp:
        cfg.model["backbone"]["dtype"] = "bfloat16"
        cfg.model["head"]["dtype"] = "bfloat16"
    if args.auto_scale_lr and "auto_scale_lr" in cfg:
        base = cfg.auto_scale_lr.get("base_batch_size", 512)
        bs = cfg.train_dataloader.get("batch_size", base)
        cfg.optim_wrapper["optimizer"]["lr"] = cfg.optim_wrapper["optimizer"]["lr"] * (bs / base)
    cfg.seed = args.seed
    if args.cfg_options:
        cfg.merge_from_dict(dict(parse_cfg_option(kv) for kv in args.cfg_options))
    return cfg


def main(argv: Optional[Sequence[str]] = None, hooks: Sequence = ()) -> Runner:
    """Train; returns the runner. ``hooks`` are appended to the config's
    ``custom_hooks`` (for a caller that watches the run)."""
    args = parse_args(argv)
    cfg = merge_args(Config.fromfile(args.config), args)
    if args.resume not in (None, "auto"):
        cfg.resume_from = args.resume
    if args.no_validate:
        cfg.val_evaluator = None
    runner = Runner.from_cfg(cfg, device=args.device)
    runner.hooks.extend(hooks)
    try:
        runner.train()
    finally:
        runner.close()
        stop_workers()
    return runner


if __name__ == "__main__":
    main()
