"""The runner: training, validation and checkpoints.

The port's own ``Runner`` (``probpose_code_tpu/engine/runner.py:48``),
built from a config (``from_cfg``, ``:354``). Evaluation: it makes the val
loader (``build_val_loader``, ``:129``) and the evaluator
(``build_evaluator``, ``:141``) and runs ``val`` (``:252-300``) for top-down
models: each batch's canvases are moved to the model's device and warped
there (``PoseModel.device_preprocess_batch``, crops rounded to uint8
values; a JPEG batch's files are decoded there first), the predict program
runs, ``attach_predictions`` (``:389``) maps the keypoints back to the
image, and the evaluator scores them.

Training (``:117-127``, ``:156-249``, ``:302-349``): ``build_train_loader``
(shuffled, the last partial batch dropped, per-batch seeds, workers kept
across epochs), ``setup_training`` (``build_optimizer`` with
``steps_per_epoch = len(train_loader)``), and ``train``, the mmengine
epoch loop: ``make_train_step`` on every batch (K3 for every tanh-GELU
layer), the hooks of ``custom_hooks``, the logger every
``default_hooks.logger.interval`` steps, checkpoints every
``default_hooks.checkpoint.interval`` epochs and at the end, validation
every ``train_cfg.val_interval`` epochs and at the end (in eval mode, then
back to train mode), the best checkpoint by ``save_best``, and resuming
from the newest ``epoch_N.pth`` (or a given file) when ``cfg.resume`` is
set. One generator on the model's device, seeded from ``cfg.seed``, draws
the stochastic-depth masks; checkpoints keep its state, so a resumed run
draws what an unbroken one would.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import probpose_code_torch.engine.hooks  # noqa: F401  (registers the hooks)
import probpose_code_torch.evaluation  # noqa: F401  (registers the metric and evaluators)
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.loader import HOST_KEYS, DataLoader
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.engine.checkpoint import (
    adam_state_from_checkpoint,
    latest_checkpoint,
    read_checkpoint,
    save_checkpoint,
)
from probpose_code_torch.engine.optim import build_optimizer
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.parallel import TrainState, create_train_state, make_train_step
from probpose_code_torch.registry import DATASETS, EVALUATORS, HOOKS
from probpose_code_torch.structures.data_sample import InstanceData
from probpose_code_torch.visualization import build_vis_backends

PRED_FIELDS = ("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error", "keypoints_conf")
# the predict dict's maps and vectors, which stay on the device (DoubleProbMapHead's
# out-window maps, RTMCCHead's SimCC vectors)
HEATMAP_KEYS = ("heatmaps", "out_heatmaps", "keypoint_x_labels", "keypoint_y_labels")


class Runner:
    """``device=None`` means the card: it raises when CUDA is absent, and
    never falls back to the CPU; pass ``device="cpu"`` for the CPU. The
    model's weights are random, drawn from seed 0, until the caller loads
    a checkpoint (``engine.checkpoint.load_checkpoint``) or training resumes
    from one."""

    def __init__(self, cfg: Config, device=None, work_dir: Optional[str] = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Runner: no CUDA device; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.cfg = cfg
        self.work_dir = work_dir or cfg.get("work_dir", "work_dirs/default")
        self.log_file: Optional[str] = None  # train.log in the work dir, once training starts
        self.train_dataloader_cfg = cfg.get("train_dataloader")
        self.val_dataloader_cfg = cfg.get("val_dataloader")
        self.train_loader = None
        self.val_loader = None
        self.val_dataset = None
        # the last ``val`` on the host clock, in seconds: waiting for batches
        # (the first one apart as well), the device (canvases moved and
        # warped or JPEGs decoded and warped, predict, outputs copied back),
        # attaching and processing the predictions, and the evaluator's
        # ``evaluate``; and the JPEG decodes inside ``device``, ``decode`` on
        # the card's clock (the host's on the CPU) and ``decode_host`` on the
        # host's, the issuing thread blocked in the host's Huffman decode
        self.val_times: Dict[str, float] = {}
        # each epoch of the last ``train`` on the host clock (see ``_train_epoch``)
        self.train_times: List[Dict[str, float]] = []
        # the logged steps: step, lr and the step's metrics as floats
        self.train_log: List[Dict[str, float]] = []

        train_ds_cfg = (cfg.get("train_dataloader") or {}).get("dataset", {})
        self.metainfo = parse_pose_metainfo(dict(train_ds_cfg.get("metainfo") or {"dataset_name": "coco"}))
        self.model = PoseModel(cfg["model"], metainfo=self.metainfo, device=device)
        self.model.init_weights(seed=0)

        train_cfg = cfg.get("train_cfg") or {}
        hooks_cfg = cfg.get("default_hooks") or {}
        ckpt_cfg = hooks_cfg.get("checkpoint") or {}
        self.max_epochs = train_cfg.get("max_epochs", 1)
        self.val_interval = train_cfg.get("val_interval", 10)
        self.log_interval = (hooks_cfg.get("logger") or {}).get("interval", 50)
        self.ckpt_interval = ckpt_cfg.get("interval", 10)
        self.save_best = ckpt_cfg.get("save_best")
        # mmengine's rule: an explicit rule wins, else error-like keys are minimized
        rule = ckpt_cfg.get("rule")
        if rule is None and self.save_best:
            key = str(self.save_best).lower()
            rule = "less" if any(t in key for t in ("nme", "epe", "mpjpe", "loss", "error")) else "greater"
        self.save_best_rule = rule or "greater"
        self.best_metric = -np.inf if self.save_best_rule == "greater" else np.inf
        self.state: Optional[TrainState] = None
        self.epoch = 0
        self.hooks = [HOOKS.build(h) for h in cfg.get("custom_hooks", [])]
        self.vis_backends = []

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(line + "\n")

    def build_train_loader(self) -> DataLoader:
        """Shuffled, the last partial batch dropped, workers kept across
        epochs, no data samples (the step reads only the arrays)."""
        cfg = dict(self.train_dataloader_cfg)
        return DataLoader(DATASETS.build(cfg["dataset"]), batch_size=cfg.get("batch_size", 32),
                          shuffle=cfg.get("sampler", {}).get("shuffle", True), drop_last=True,
                          num_workers=cfg.get("num_workers", 4), with_data_samples=False, persistent_workers=True)

    def build_val_loader(self) -> DataLoader:
        cfg = dict(self.val_dataloader_cfg)
        self.val_dataset = DATASETS.build(cfg["dataset"])
        return DataLoader(self.val_dataset, batch_size=cfg.get("batch_size", 32), num_workers=cfg.get("num_workers", 4))

    def build_evaluator(self):
        ev_cfg = self.cfg.get("val_evaluator")
        if ev_cfg is None:
            raise KeyError("the config has no val_evaluator")
        if isinstance(ev_cfg, dict) and ev_cfg.get("type") in ("MultiDatasetEvaluator", "Evaluator"):
            evaluator = EVALUATORS.build(ev_cfg)
        elif isinstance(ev_cfg, (list, tuple)):
            evaluator = EVALUATORS.build(dict(type="Evaluator", metrics=list(ev_cfg)))
        else:
            evaluator = EVALUATORS.build(dict(type="Evaluator", metrics=[ev_cfg]))
        evaluator.dataset_meta = self.metainfo
        return evaluator

    # -- training ---------------------------------------------------------

    def setup_training(self, steps_per_epoch: Optional[int] = None) -> None:
        """The optimizer, its schedule, the train state, the step and the
        generator; kept across ``train`` calls."""
        if self.state is not None:
            return
        if steps_per_epoch is None:
            steps_per_epoch = len(self.train_loader) if self.train_loader else 1000
        self.optimizer, self.lr_fn = build_optimizer(
            self.model, self.cfg.get("optim_wrapper", {}), self.cfg.get("param_scheduler"),
            steps_per_epoch=steps_per_epoch, max_epochs=self.max_epochs,
        )
        self.state = create_train_state(self.model, self.optimizer)
        self.train_step = make_train_step(self.model, self.optimizer)
        self.generator = torch.Generator(device=self.model.device).manual_seed(int(self.cfg.get("seed", 0)))

    def train(self, max_epochs: Optional[int] = None) -> TrainState:
        if self.train_loader is None:
            self.train_loader = self.build_train_loader()
        self.setup_training()
        if self.cfg.get("resume"):
            self.try_resume(self.cfg.get("resume_from"))
        max_epochs = max_epochs or self.max_epochs
        evaluator = self.build_evaluator() if self.cfg.get("val_evaluator") else None
        os.makedirs(self.work_dir, exist_ok=True)
        self.log_file = osp.join(self.work_dir, "train.log")
        if not self.vis_backends:
            self.vis_backends = build_vis_backends(self.cfg, self.work_dir)
        self.train_times = []

        for hook in self.hooks:
            hook.before_run(self)
        for epoch in range(self.epoch, max_epochs):
            self.epoch = epoch
            for hook in self.hooks:
                hook.before_train_epoch(self, epoch)
            self.train_loader.set_epoch(epoch)
            times = self._train_epoch(epoch)

            t0 = time.perf_counter()
            save_ckpt = (epoch + 1) % self.ckpt_interval == 0 or epoch + 1 == max_epochs
            run_val = evaluator is not None and ((epoch + 1) % self.val_interval == 0 or epoch + 1 == max_epochs)
            if save_ckpt or run_val:
                # EMA-style hooks swap their averaged weights in here, so that
                # val, the best checkpoint and the saved ones all see them
                for hook in self.hooks:
                    hook.before_eval(self)
            if save_ckpt:
                self.save_checkpoint(osp.join(self.work_dir, f"epoch_{epoch + 1}.pth"))
            t1 = time.perf_counter()
            if run_val:
                self.model.eval()
                metrics = self.val(evaluator)
                self.model.train()
                for hook in self.hooks:
                    hook.after_val_epoch(self, metrics)
            t2 = time.perf_counter()
            if run_val:
                self._maybe_save_best(metrics)
            if save_ckpt or run_val:
                for hook in self.hooks:
                    hook.after_eval(self)
            t3 = time.perf_counter()
            times.update(val=t2 - t1, checkpoint=t3 - t2 + t1 - t0)
            self.train_times.append(times)
        for hook in self.hooks:
            hook.after_run(self)
        return self.state

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train loader. Returns its times on the host
        clock, in seconds: ``window`` from the start of the loader to the end
        of the last step (the device synchronized), split into the waits for
        batches (``loader``, and the first one alone, ``first_batch``), the
        steps (``step``: the batch moved to the device, a copy that waits for
        the previous step's kernels, and the step issued; the last one run
        to its end) and the hooks and logging (``hooks``, where the logged
        metrics are read back); the JPEG decodes inside the steps,
        ``decode`` on the card's clock (the host's on the CPU) and
        ``decode_host`` on the host's; and the epoch's ``crops``."""
        times = dict(loader=0.0, step=0.0, hooks=0.0, crops=0)
        n = len(self.train_loader)
        self.model.decode_clock.take()
        start = t0 = time.perf_counter()
        for i, batch in enumerate(self.train_loader):
            t1 = time.perf_counter()
            times.setdefault("first_batch", t1 - t0)
            times["loader"] += t1 - t0
            batch.pop("data_samples", None)
            times["crops"] += sum(len(batch[k]) for k in ("warp_mat", "jpeg_warp_mat") if k in batch)
            self.state, metrics = self.train_step(self.state, self.to_device(batch), self.generator)
            if i + 1 == n and self.model.device.type == "cuda":
                torch.cuda.synchronize(self.model.device)  # the window ends with the last step's kernels
            t2 = time.perf_counter()
            times["step"] += t2 - t1
            step = self.state.step
            for hook in self.hooks:
                hook.after_train_iter(self, step, metrics)
            if (i + 1) % self.log_interval == 0:
                host = {k: float(v) for k, v in metrics.items()}
                lr = self.lr_fn(step)
                self.train_log.append(dict(step=step, lr=lr, **host))
                for backend in self.vis_backends:
                    backend.add_scalars({f"train/{k}": v for k, v in host.items()}, step)
                self.log(f"Epoch [{epoch + 1}][{i + 1}/{n}] lr: {lr:.2e} "
                         + " ".join(f"{k}: {v:.4f}" for k, v in host.items())
                         + f" data_time: {times['loader'] / (i + 1):.3f}s step_time: {times['step'] / (i + 1):.3f}s")
            t0 = time.perf_counter()
            times["hooks"] += t0 - t2
        times["window"] = t0 - start
        times.update(self.model.decode_clock.take())
        return times

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the model's device; its JPEG files as they
        are (the device decodes them in ``device_preprocess_batch``)."""
        device = self.model.device
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()
               if isinstance(v, np.ndarray)}
        out.update({k: batch[k] for k in HOST_KEYS if k in batch})
        return out

    def _maybe_save_best(self, metrics: Dict[str, float]) -> None:
        if not self.save_best:
            return
        # an exact key, or one that ends in "/<save_best>" (metrics are prefixed)
        key = self.save_best if self.save_best in metrics else next(
            (k for k in metrics if k.endswith("/" + self.save_best)), None)
        if key is None:
            return
        better = (metrics[key] > self.best_metric) if self.save_best_rule == "greater" \
            else (metrics[key] < self.best_metric)
        if better:
            self.best_metric = metrics[key]
            self.save_checkpoint(osp.join(self.work_dir, "best.pth"))
            self.log(f"new best {key}: {self.best_metric:.4f}")

    def save_checkpoint(self, path: str) -> None:
        """The training state as a ``.pth`` file: mmpose's ``iter`` and the
        JAX runner's ``step`` are both the updates applied."""
        step = self.state.step
        save_checkpoint(path, self.model, self.optimizer, self.state.opt_state,
                        meta=dict(epoch=self.epoch + 1, iter=step, step=step, dataset_meta=self.metainfo,
                                  best_score=float(self.best_metric)),
                        generator=self.generator.get_state())
        self.log(f"checkpoint saved to {path}")

    def try_resume(self, path: Optional[str] = None) -> None:
        """Continue from ``path``, or else the work dir's newest
        ``epoch_N.pth`` (nothing when there is none): the weights, the
        optimizer's moments, the step, the epoch, the best score and the
        generator's state."""
        path = path or latest_checkpoint(self.work_dir)
        if path is None:
            return
        ckpt = read_checkpoint(path)
        self.model.module.load_state_dict(ckpt["state_dict"])
        meta = ckpt.get("meta", {})
        opt_state = self.state.opt_state
        if ckpt.get("optimizer") is not None:
            opt_state = adam_state_from_checkpoint(self.optimizer, ckpt["optimizer"])
        self.state = TrainState(step=int(meta.get("step", 0)), model=self.model, opt_state=opt_state)
        if "generator" in ckpt:
            self.generator.set_state(ckpt["generator"])
        if "best_score" in meta:
            self.best_metric = float(meta["best_score"])
        self.epoch = int(meta.get("epoch", 0))
        self.log(f"resumed from {path} (epoch {self.epoch}, step {self.state.step})")

    def close(self) -> None:
        """End the train loader's workers and close the logging backends."""
        if self.train_loader is not None:
            self.train_loader.close()
        for backend in self.vis_backends:
            backend.close()

    # -- evaluation -------------------------------------------------------

    def device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the model's device, canvases warped."""
        return self.model.device_preprocess_batch(self.to_device(batch))

    def val(self, evaluator=None) -> Dict[str, float]:
        """One pass over the val loader; the evaluator's metrics."""
        if self.val_loader is None:
            self.val_loader = self.build_val_loader()
        if evaluator is None:
            evaluator = self.build_evaluator()
        predict = self.model.make_predict()

        times = dict(loader=0.0, device=0.0, process=0.0)
        self.model.decode_clock.take()
        t0 = time.perf_counter()
        for batch in self.val_loader:
            t1 = time.perf_counter()
            times.setdefault("first_batch", t1 - t0)
            data_samples = batch["data_samples"]
            preds = predict(self.device_batch(batch)["inputs"])
            preds = {k: v.float().cpu().numpy() for k, v in preds.items() if k not in HEATMAP_KEYS}
            t2 = time.perf_counter()
            attach_predictions(preds, data_samples, self.model.input_size)
            evaluator.process(data_samples)
            t3 = time.perf_counter()
            times["loader"] += t1 - t0
            times["device"] += t2 - t1
            times["process"] += t3 - t2
            t0 = t3
        metrics = evaluator.evaluate(len(self.val_loader.dataset))
        times["evaluate"] = time.perf_counter() - t0
        times.update(self.model.decode_clock.take())
        self.val_times = times
        for backend in self.vis_backends:
            backend.add_scalars({f"val/{k}": v for k, v in metrics.items()}, self.state.step if self.state else 0)
        self.log("val: " + " ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
        return metrics

    @staticmethod
    def from_cfg(cfg, device=None) -> "Runner":
        if not isinstance(cfg, Config):
            cfg = Config.fromdict(dict(cfg))
        return Runner(cfg, device=device, work_dir=cfg.get("work_dir"))


def attach_predictions(preds: Dict[str, np.ndarray], data_samples: List, input_size) -> None:
    """Attach batched predict-program outputs to data samples, restoring
    coordinates from model-input space to original image space (reference
    ``topdown.py:add_pred_to_datasample:128-167``)."""
    for i, sample in enumerate(data_samples):
        input_center = np.asarray(sample.metainfo["input_center"])
        input_scale = np.asarray(sample.metainfo["input_scale"])
        w_h = np.asarray(sample.metainfo.get("input_size", input_size), dtype=np.float32)
        kpts = preds["keypoints"][i] / w_h * input_scale + input_center - 0.5 * input_scale

        inst = InstanceData()
        inst.set_field(kpts[None], "keypoints")
        inst.set_field(preds["keypoint_scores"][i][None], "keypoint_scores")
        for name in PRED_FIELDS:
            if name in preds:
                inst.set_field(preds[name][i][None], name)
        gt = sample.gt_instances
        if "bboxes" in gt:
            inst.set_field(np.asarray(gt.bboxes), "bboxes")
        if "bbox_scores" in gt:
            inst.set_field(np.asarray(gt.bbox_scores), "bbox_scores")
        sample.pred_instances = inst
