"""The evaluation half of the runner.

The port's own ``Runner`` (``probpose_code_tpu/engine/runner.py:48``): built
from a config (``from_cfg``, ``:354``), it makes the val loader
(``build_val_loader``, ``:129``) and the evaluator (``build_evaluator``,
``:141``) and runs ``val`` (``:252-300``) for top-down models: each batch's
canvases are moved to the model's device and warped there
(``PoseModel.device_preprocess_batch``, crops rounded to uint8 values), the
predict program runs, ``attach_predictions`` (``:389``) maps the keypoints
back to the image, and the evaluator scores them. Training, hooks and
checkpoint writing come with the port's training-runner slice.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

import probpose_code_torch.evaluation  # noqa: F401  (registers the metric and evaluators)
from probpose_code_torch.config import Config
from probpose_code_torch.datasets.loader import DataLoader
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.models.builder import PoseModel
from probpose_code_torch.registry import DATASETS, EVALUATORS
from probpose_code_torch.structures.data_sample import InstanceData

PRED_FIELDS = ("keypoints_probs", "keypoints_visible", "keypoints_oks", "keypoints_error", "keypoints_conf")


class Runner:
    """``device=None`` means the card: it raises when CUDA is absent, and
    never falls back to the CPU; pass ``device="cpu"`` for the CPU. The
    model's weights are random, drawn from seed 0, until the caller loads
    a checkpoint (``engine.checkpoint.load_checkpoint``)."""

    def __init__(self, cfg: Config, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Runner: no CUDA device; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.cfg = cfg
        self.val_dataloader_cfg = cfg.get("val_dataloader")
        self.val_loader = None
        self.val_dataset = None
        # the last ``val`` on the host clock, in seconds: waiting for batches
        # (the first one apart as well), the device (canvases moved and
        # warped, predict, outputs copied back), attaching and processing
        # the predictions, and the evaluator's ``evaluate``
        self.val_times: Dict[str, float] = {}

        train_ds_cfg = (cfg.get("train_dataloader") or {}).get("dataset", {})
        self.metainfo = parse_pose_metainfo(dict(train_ds_cfg.get("metainfo") or {"dataset_name": "coco"}))
        self.model = PoseModel(cfg["model"], metainfo=self.metainfo, device=device)
        self.model.init_weights(seed=0)

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

    def device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the model's device, canvases warped."""
        device = self.model.device
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in batch.items() if isinstance(v, np.ndarray)}
        return self.model.device_preprocess_batch(arrays)

    def val(self, evaluator=None) -> Dict[str, float]:
        """One pass over the val loader; the evaluator's metrics."""
        if self.val_loader is None:
            self.val_loader = self.build_val_loader()
        if evaluator is None:
            evaluator = self.build_evaluator()
        predict = self.model.make_predict()

        times = dict(loader=0.0, device=0.0, process=0.0)
        t0 = time.perf_counter()
        for batch in self.val_loader:
            t1 = time.perf_counter()
            times.setdefault("first_batch", t1 - t0)
            data_samples = batch["data_samples"]
            preds = predict(self.device_batch(batch)["inputs"])
            preds = {k: v.float().cpu().numpy() for k, v in preds.items() if k != "heatmaps"}
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
        self.val_times = times
        print(f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] val: " + " ".join(f"{k}: {v:.4f}" for k, v in metrics.items()),
              flush=True)
        return metrics

    @staticmethod
    def from_cfg(cfg, device=None) -> "Runner":
        if not isinstance(cfg, Config):
            cfg = Config.fromdict(dict(cfg))
        return Runner(cfg, device=device)


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
