"""2D keypoint accuracy metrics: PCK (bbox, head and torso norms), MPII's
PCKh, JHMDB's PCK, AUC, EPE and NME.

The port's own copy of ``probpose_code_tpu/evaluation/metrics/
keypoint_2d_metrics.py:34-248`` (reference ``mmpose/evaluation/metrics/
keypoint_2d_metrics.py``). Each metric keeps per sample the predicted and
ground-truth keypoints (image pixels), the annotated mask (the first
channel of a ``KeypointConverter``'s stacked ``keypoints_visible``) and the
norm sizes it reads: the box's longer side, ``head_size`` or the distance
of keypoints 4 and 5; ``NME`` a norm item of the sample (the box's longer
side where the sample lacks it) or the distance of two keypoints that the
dataset's name picks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from probpose_code_torch.registry import METRICS

from ..base_metric import BaseMetric
from ..functional.keypoint_eval import keypoint_auc, keypoint_epe, keypoint_nme, keypoint_pck_accuracy
from .coco_metric import _sample_view


def _collect(results):
    pred = np.concatenate([r["pred_coords"] for r in results])
    gt = np.concatenate([r["gt_coords"] for r in results])
    mask = np.concatenate([r["mask"] for r in results])
    return pred, gt, mask


class _KeypointMetricBase(BaseMetric):
    """Per-sample predicted and ground-truth coordinates, the mask, and the
    norm sizes of ``norm_items``."""

    norm_items: Sequence[str] = ()

    def process(self, data_batch, data_samples: Sequence) -> None:
        for raw in data_samples:
            s = _sample_view(raw)
            pred = np.asarray(s["pred_instances"]["keypoints"])
            if pred.ndim == 2:
                pred = pred[None]
            gt_inst = s["gt_instances"]
            gt = np.asarray(gt_inst["keypoints"])
            mask = np.asarray(gt_inst.get("keypoints_visible", np.ones(gt.shape[:2]))).astype(bool)
            if mask.ndim == 3:
                mask = mask[..., 0]
            result = dict(pred_coords=pred[..., :2], gt_coords=gt[..., :2], mask=mask)
            if "bbox" in self.norm_items:
                bboxes = np.asarray(gt_inst["bboxes"]).reshape(-1, 4)
                bbox_size = np.max(bboxes[:, 2:] - bboxes[:, :2], axis=1)
                result["bbox_size"] = np.tile(bbox_size[:, None], (1, 2))
            if "head" in self.norm_items:
                head_size = np.asarray(gt_inst["head_size"]).reshape(-1, 1)
                result["head_size"] = np.tile(head_size, (1, 2))
            if "torso" in self.norm_items:
                kpts = gt.reshape(gt.shape[0], -1, 2)
                torso = np.linalg.norm(kpts[:, 4] - kpts[:, 5], axis=-1, keepdims=True)
                result["torso_size"] = np.tile(np.clip(torso, 1e-6, None), (1, 2))
            self.results.append(result)


@METRICS.register_module()
class PCKAccuracy(_KeypointMetricBase):
    """PCK at ``thr`` of each norm item: ``PCK`` (bbox), ``PCKh`` (head),
    ``tPCK`` (torso)."""

    default_prefix = "pck"
    NAMES = dict(bbox="PCK", head="PCKh", torso="tPCK")

    def __init__(self, thr: float = 0.05, norm_item="bbox", prefix: Optional[str] = None):
        super().__init__(prefix=prefix)
        self.thr = thr
        self.norm_items = [norm_item] if isinstance(norm_item, str) else list(norm_item)
        for item in self.norm_items:
            if item not in self.NAMES:
                raise ValueError(f"PCKAccuracy: norm_item {item!r} is not one of {list(self.NAMES)}")

    def compute_metrics(self, results: list) -> Dict[str, float]:
        pred, gt, mask = _collect(results)
        metrics = {}
        for item in ("bbox", "head", "torso"):
            if item in self.norm_items:
                norm = np.concatenate([r[f"{item}_size"] for r in results])
                _, metrics[self.NAMES[item]], _ = keypoint_pck_accuracy(pred, gt, mask, self.thr, norm)
        return metrics


@METRICS.register_module()
class MpiiPCKAccuracy(PCKAccuracy):
    """MPII's PCKh@0.5 (reference ``keypoint_2d_metrics.py:290-355``): the
    predictions shifted by +1 px (MATLAB's 1-based ground truth), the
    pelvis and thorax (joints 6, 7) out of the mean, which weighs each joint
    by its count, ``PCK`` and ``PCK@0.1`` and the table by body part."""

    default_prefix = "mpii"

    def __init__(self, thr: float = 0.5, norm_item="head", prefix: Optional[str] = None):
        super().__init__(thr=thr, norm_item=norm_item, prefix=prefix)

    def compute_metrics(self, results: list) -> Dict[str, float]:
        pred, gt, mask = _collect(results)
        norm = np.concatenate([r["head_size"] for r in results])
        pred = pred + 1.0
        acc, _, _ = keypoint_pck_accuracy(pred, gt, mask, self.thr, norm)
        PCKh = 100.0 * acc
        if pred.shape[1] != 16:
            return {"PCK": float(np.mean(PCKh[PCKh >= 0]))}

        jnt_count = mask.sum(axis=0).astype(np.float64)
        keep = np.ones(16, bool)
        keep[6:8] = False
        jnt_ratio = np.where(keep, jnt_count, 0.0)
        jnt_ratio = jnt_ratio / max(jnt_ratio.sum(), 1e-12)
        acc01, _, _ = keypoint_pck_accuracy(pred, gt, mask, 0.1, norm)
        # MPII's joints: head 9; shoulders 13 / 12, elbows 14 / 11, wrists 15 / 10, hips 3 / 2, knees 4 / 1,
        # ankles 5 / 0
        return {
            "Head PCK": float(PCKh[9]),
            "Shoulder PCK": float(0.5 * (PCKh[13] + PCKh[12])),
            "Elbow PCK": float(0.5 * (PCKh[14] + PCKh[11])),
            "Wrist PCK": float(0.5 * (PCKh[15] + PCKh[10])),
            "Hip PCK": float(0.5 * (PCKh[3] + PCKh[2])),
            "Knee PCK": float(0.5 * (PCKh[4] + PCKh[1])),
            "Ankle PCK": float(0.5 * (PCKh[5] + PCKh[0])),
            "PCK": float(np.sum(np.where(keep, PCKh, 0.0) * jnt_ratio)),
            "PCK@0.1": float(np.sum(np.where(keep, 100.0 * acc01, 0.0) * jnt_ratio)),
        }


@METRICS.register_module()
class JhmdbPCKAccuracy(PCKAccuracy):
    """JHMDB's PCK under the bbox and torso norms."""

    default_prefix = "jhmdb"

    def __init__(self, thr: float = 0.05, norm_item=("bbox", "torso"), prefix: Optional[str] = None):
        super().__init__(thr=thr, norm_item=norm_item, prefix=prefix)


@METRICS.register_module()
class AUC(_KeypointMetricBase):
    """The area under the PCK curve over distances of 0 to ``norm_factor``
    pixels."""

    default_prefix = "auc"

    def __init__(self, norm_factor: float = 30, num_thrs: int = 20, prefix: Optional[str] = None):
        super().__init__(prefix=prefix)
        self.norm_factor = norm_factor
        self.num_thrs = num_thrs

    def compute_metrics(self, results: list) -> Dict[str, float]:
        pred, gt, mask = _collect(results)
        return {"AUC": keypoint_auc(pred, gt, mask, self.norm_factor, self.num_thrs)}


@METRICS.register_module()
class EPE(_KeypointMetricBase):
    """The mean end-point error in pixels."""

    default_prefix = "epe"

    def compute_metrics(self, results: list) -> Dict[str, float]:
        pred, gt, mask = _collect(results)
        return {"EPE": keypoint_epe(pred, gt, mask)}


@METRICS.register_module()
class NME(_KeypointMetricBase):
    """The normalized mean error of the face benchmarks: under
    ``norm_mode="use_norm_item"`` each sample's distances over its
    ``norm_item`` (``box_size``; the box's longer side where the sample has
    no such field, as for AFLW's ``bbox_size``, and 1 where it has no box
    either), under ``"keypoint_distance"`` over the distance of the ground
    truth's two ``keypoint_indices`` (by default the dataset's inter-ocular
    pair, ``DEFAULT_KEYPOINT_INDICES``; [0, 1] for another dataset), at
    least 1e-6."""

    default_prefix = "nme"
    DEFAULT_KEYPOINT_INDICES = {"horse10": [0, 1], "300w": [36, 45], "coco_wholebody_face": [36, 45],
                                "cofw": [8, 9], "wflw": [60, 72], "lapa": [66, 79]}
    MODES = ("use_norm_item", "keypoint_distance")

    def __init__(self, norm_mode: str = "use_norm_item", norm_item: str = "box_size",
                 keypoint_indices: Optional[Sequence[int]] = None, prefix: Optional[str] = None):
        super().__init__(prefix=prefix)
        if norm_mode not in self.MODES:
            raise ValueError(f"NME: norm_mode {norm_mode!r} is not one of {list(self.MODES)}")
        self.norm_mode = norm_mode
        self.norm_item = norm_item
        self.keypoint_indices = keypoint_indices

    def process(self, data_batch, data_samples: Sequence) -> None:
        start = len(self.results)
        super().process(data_batch, data_samples)
        if self.norm_mode != "use_norm_item":
            return
        for raw, result in zip(data_samples, self.results[start:]):
            gt_inst = _sample_view(raw)["gt_instances"]
            if self.norm_item in gt_inst:
                size = np.asarray(gt_inst[self.norm_item]).reshape(-1, 1)
            elif "bboxes" in gt_inst:
                bb = np.asarray(gt_inst["bboxes"]).reshape(-1, 4)
                size = np.max(bb[:, 2:] - bb[:, :2], axis=1, keepdims=True)
            else:
                size = np.ones((result["pred_coords"].shape[0], 1), np.float32)
            result["norm_size"] = np.tile(size, (1, 2))

    def compute_metrics(self, results: list) -> Dict[str, float]:
        pred, gt, mask = _collect(results)
        if self.norm_mode == "use_norm_item":
            norm = np.concatenate([r["norm_size"] for r in results])
        else:
            indices = self.keypoint_indices
            if indices is None:
                indices = self.DEFAULT_KEYPOINT_INDICES.get((self.dataset_meta or {}).get("dataset_name", ""), [0, 1])
            d = np.linalg.norm(gt[:, indices[0]] - gt[:, indices[1]], axis=-1, keepdims=True)
            norm = np.tile(np.clip(d, 1e-6, None), (1, 2))
        return {"NME": keypoint_nme(pred, gt, mask, norm)}
