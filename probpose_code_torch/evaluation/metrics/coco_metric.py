"""CocoMetric: COCO AP and Ex-OKS evaluation.

The port's own copy of ``probpose_code_tpu/evaluation/metrics/coco_metric.py``
(``CocoMetric``, ``:56``; reference ``mmpose/evaluation/metrics/coco_metric.py``):

- ``process``: per-sample predictions with the ProbPose fields
  (keypoints_probs / oks / error / visible) and the GT for ann-file-free
  evaluation;
- ``pad_to_contain`` computed for the GT annotations;
- the scoring modes (bbox / keypoint / bbox_keypoint / bbox_rle) with
  ``score_thresh_type='prob'``; the v channel of the dumped keypoints is the
  predicted in-image probability;
- OKS-NMS / soft-OKS-NMS and the results in COCO's result format (kept in
  memory: the JAX package writes them to a json file and reads it back);
- the visibility / probability classification accuracies, whose learned
  probability threshold ``prob_thr`` is the Ex-OKS evaluator's
  ``confidence_thr``;
- the COCOeval grid over ``extended`` x ``match_by_bbox`` with the stat
  prefixes ``Ex_`` / ``bbox_`` and the suffix ``_NoBrd``.

The JAX package's opt-in plotting diagnostics (``diagnostics=True``) are not
ported.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from probpose_code_torch.datasets.coco_api import COCO
from probpose_code_torch.registry import METRICS
from probpose_code_torch.structures.bbox import bbox_xyxy2xywh
from probpose_code_torch.structures.keypoint import find_min_padding_exact

from ..base_metric import BaseMetric
from ..cocoeval import COCOeval
from ..functional.nms import oks_nms, soft_oks_nms


def _sample_view(sample) -> dict:
    """Uniform dict view over PoseDataSample / dict samples."""
    if isinstance(sample, dict):
        return sample
    view = dict(sample.metainfo)
    view["pred_instances"] = {k: np.asarray(v) for k, v in sample.pred_instances.items()}
    view["gt_instances"] = {k: np.asarray(v) if not isinstance(v, list) else v
                            for k, v in sample.gt_instances.items()}
    return view


@METRICS.register_module()
class CocoMetric(BaseMetric):
    default_prefix: Optional[str] = "coco"

    def __init__(
        self,
        ann_file: Optional[str] = None,
        use_area: bool = True,
        iou_type: str = "keypoints",
        score_mode: str = "bbox_keypoint",
        score_thresh_type: str = "score",
        keypoint_score_thr: float = 0.2,
        nms_mode: str = "oks_nms",
        nms_thr: float = 0.9,
        prefix: Optional[str] = None,
        extended: List[bool] = [False],
        match_by_bbox: List[bool] = [False],
        ignore_border_points: List[bool] = [False],
        padding: float = 1.25,
    ):
        super().__init__(prefix=prefix)
        self.ann_file = ann_file
        self.coco = COCO(ann_file) if ann_file is not None else None

        self.use_area = use_area
        self.iou_type = iou_type
        assert score_mode in ("bbox", "bbox_keypoint", "bbox_rle", "keypoint")
        self.score_mode = score_mode
        assert score_thresh_type in ("score", "prob")
        self.score_thresh_type = score_thresh_type
        self.keypoint_score_thr = keypoint_score_thr
        assert nms_mode in ("oks_nms", "soft_oks_nms", "none")
        self.nms_mode = nms_mode
        self.nms_thr = nms_thr

        n = max(len(extended), len(match_by_bbox))
        extended = extended * n if len(extended) == 1 and n > 1 else extended
        match_by_bbox = match_by_bbox * n if len(match_by_bbox) == 1 and n > 1 else match_by_bbox
        if len(ignore_border_points) == 1 and n > 1:
            ignore_border_points = ignore_border_points * n
        assert len(extended) == len(match_by_bbox) >= 1
        self.extended = extended
        self.match_by_bbox = match_by_bbox
        self.ignore_border_points = ignore_border_points
        self.padding = padding

        self.prob_thr = -1.0
        self.has_probability = True
        self._compute_min_padding_in_coco()

    def _compute_min_padding_in_coco(self):
        if self.coco is None:
            return
        for ann in self.coco.anns.values():
            if "pad_to_contain" in ann:
                continue
            kpts = np.array(ann["keypoints"]).reshape(-1, 3)
            bbox = np.array(ann["bbox"]).flatten()
            ann["pad_to_contain"] = find_min_padding_exact(bbox, kpts).tolist()

    # ------------------------------------------------------------------

    def process(self, data_batch, data_samples: Sequence) -> None:
        for raw_sample in data_samples:
            sample = _sample_view(raw_sample)
            pred_inst = sample["pred_instances"]
            keypoints = np.asarray(pred_inst["keypoints"])
            if keypoints.ndim == 2:
                keypoints = keypoints[None]
            N, K, _ = keypoints.shape
            keypoint_scores = np.asarray(pred_inst["keypoint_scores"]).reshape(N, K)

            def _get(name):
                if name in pred_inst:
                    return np.asarray(pred_inst[name]).reshape(N, K)
                return keypoint_scores.copy()

            if "keypoints_probs" not in pred_inst:
                self.has_probability = False

            pred = dict(
                id=sample["id"],
                img_id=sample["img_id"],
                keypoints=keypoints,
                keypoint_scores=keypoint_scores,
                keypoints_visible=_get("keypoints_visible"),
                keypoint_probs=_get("keypoints_probs"),
                keypoint_oks=_get("keypoints_oks"),
                keypoint_error=_get("keypoints_error"),
                # bottomup samples carry a per-instance category array; the
                # COCO json wants one scalar per prediction (person=1)
                category_id=int(np.asarray(sample.get("category_id", 1)).reshape(-1)[0])
                if np.size(sample.get("category_id", 1)) else 1,
            )
            if "bboxes" in pred_inst:
                pred["bbox"] = bbox_xyxy2xywh(np.asarray(pred_inst["bboxes"]))

            gt_inst = sample.get("gt_instances", {})
            if "bbox_scores" in pred_inst:
                bbox_scores = np.asarray(pred_inst["bbox_scores"])
            elif "bbox_scores" not in gt_inst or len(np.asarray(gt_inst["bbox_scores"])) != len(keypoints):
                bbox_scores = np.ones(len(keypoints))
            else:
                bbox_scores = np.asarray(gt_inst["bbox_scores"])
            pred["bbox_scores"] = bbox_scores

            # ground truth (for ann-file-free evaluation)
            gt = dict(width=None, height=None)
            if self.coco is None:
                gt["width"], gt["height"] = sample.get("ori_shape", (None, None))[::-1] if sample.get("ori_shape") else (None, None)
                gt["img_id"] = sample["img_id"]
                gt["raw_ann_info"] = sample.get("raw_ann_info")
            self.results.append((pred, gt))

    # ------------------------------------------------------------------

    def compute_metrics(self, results: list) -> Dict[str, float]:
        preds, gts = zip(*results)

        if self.coco is None:
            self.coco = COCO(dataset=self.gt_to_coco_json(gts))
            self._compute_min_padding_in_coco()

        kpts = defaultdict(list)
        for pred in preds:
            img_id = pred["img_id"]
            for idx, keypoints in enumerate(pred["keypoints"]):
                instance = {
                    "id": pred["id"],
                    "img_id": pred["img_id"],
                    "category_id": pred["category_id"],
                    "keypoints": keypoints,
                    "keypoint_scores": pred["keypoint_scores"][idx],
                    "bbox_score": pred["bbox_scores"][idx],
                    "keypoints_visible": pred["keypoints_visible"][idx],
                    "keypoint_probs": pred["keypoint_probs"][idx],
                    "keypoint_oks": pred["keypoint_oks"][idx],
                    "keypoint_error": pred["keypoint_error"][idx],
                }
                if "bbox" in pred:
                    instance["bbox"] = pred["bbox"][idx]
                area = (np.max(keypoints[:, 0]) - np.min(keypoints[:, 0])) * (
                    np.max(keypoints[:, 1]) - np.min(keypoints[:, 1])
                )
                instance["area"] = area
                kpts[img_id].append(instance)

        kpts = self._sort_and_unique_bboxes(kpts, key="id")

        # scoring + NMS
        valid_kpts = defaultdict(list)
        for img_id, instances in kpts.items():
            for instance in instances:
                instance["keypoints"] = np.concatenate(
                    [np.asarray(instance["keypoints"]), np.asarray(instance["keypoint_probs"])[:, None]], axis=-1
                )
                if self.score_mode == "bbox":
                    instance["score"] = float(instance["bbox_score"])
                elif self.score_mode == "keypoint":
                    instance["score"] = float(np.mean(instance["keypoint_scores"]))
                elif self.score_mode == "bbox_rle":
                    ks = instance["keypoint_scores"]
                    instance["score"] = float(instance["bbox_score"] + np.mean(ks) + np.max(ks))
                else:  # bbox_keypoint
                    thresh_by = (
                        instance["keypoint_scores"]
                        if self.score_thresh_type == "score"
                        else instance["keypoint_probs"]
                    )
                    valid = thresh_by > self.keypoint_score_thr
                    mean_kpt_score = (
                        float(instance["keypoint_scores"][valid].mean()) if valid.any() else 0.0
                    )
                    instance["score"] = float(instance["bbox_score"]) * mean_kpt_score

            if self.nms_mode == "none":
                valid_kpts[img_id] = instances
            else:
                nms_fn = oks_nms if self.nms_mode == "oks_nms" else soft_oks_nms
                keep = nms_fn(instances, self.nms_thr, sigmas=self.dataset_meta["sigmas"])
                valid_kpts[img_id] = [instances[k] for k in keep]

        eval_results: "OrderedDict[str, float]" = OrderedDict()
        try:
            info = self._do_python_variables_eval(self.coco.anns, valid_kpts)
            eval_results.update(OrderedDict(info))
        except Exception:  # diagnostics must never break evaluation
            import traceback

            traceback.print_exc()

        info = self._do_python_keypoint_eval(self.results2json(valid_kpts))
        eval_results.update(OrderedDict(info))
        return eval_results

    # ------------------------------------------------------------------

    @staticmethod
    def gt_to_coco_json(gt_dicts: Sequence[dict]) -> dict:
        """The raw GT annotations carried by the samples as a COCO dataset."""
        image_infos = []
        annotations = []
        img_ids = set()
        ann_ids = set()
        for gt_dict in gt_dicts:
            if gt_dict.get("img_id") is None or gt_dict.get("raw_ann_info") is None:
                continue
            if gt_dict["img_id"] not in img_ids:
                image_infos.append(
                    dict(id=gt_dict["img_id"], width=gt_dict.get("width"), height=gt_dict.get("height"))
                )
                img_ids.add(gt_dict["img_id"])
            raw = gt_dict["raw_ann_info"]
            raw_list = raw if isinstance(raw, list) else [raw]
            for ann in raw_list:
                if ann is None or ann["id"] in ann_ids:
                    continue
                ann_ids.add(ann["id"])
                annotations.append(dict(ann))
        return dict(info={}, images=image_infos, categories=[dict(id=1, name="person")], licenses=None,
                    annotations=annotations)

    def results2json(self, keypoints: Dict[int, list]) -> List[dict]:
        """The kept instances in COCO's keypoint result format."""
        num_keypoints = self.dataset_meta["num_keypoints"]
        cat_results = []
        for _, img_kpts in keypoints.items():
            if not img_kpts:
                continue
            _keypoints = np.array([ik["keypoints"] for ik in img_kpts]).reshape(-1, num_keypoints * 3)
            for img_kpt, keypoint in zip(img_kpts, _keypoints):
                res = {
                    "image_id": int(img_kpt["img_id"]),
                    "category_id": int(img_kpt["category_id"]),
                    "keypoints": keypoint.tolist(),
                    "score": float(img_kpt["score"]),
                }
                if "bbox" in img_kpt:
                    res["bbox"] = np.asarray(img_kpt["bbox"]).tolist()
                if "keypoints_visible" in img_kpt:
                    res["visibility"] = np.asarray(img_kpt["keypoints_visible"]).tolist()
                cat_results.append(res)
        return cat_results

    def _do_python_keypoint_eval(self, results: List[dict]) -> list:
        coco_det = self.coco.loadRes(results)
        sigmas = self.dataset_meta["sigmas"]

        info_str = []
        for extended_oks, match_by_bbox, ignore_border in zip(
            self.extended, self.match_by_bbox, self.ignore_border_points
        ):
            prefix = ("Ex_" if extended_oks else "") + ("bbox_" if match_by_bbox else "")
            if extended_oks and match_by_bbox:
                prefix = "Ex_bbox_"
            elif match_by_bbox:
                prefix = "bbox_"
            elif extended_oks:
                prefix = "Ex_"
            else:
                prefix = ""
            suffix = "_NoBrd" if ignore_border else ""

            coco_eval = COCOeval(
                self.coco,
                coco_det,
                iouType=self.iou_type,
                sigmas=sigmas,
                use_area=self.use_area,
                extended_oks=extended_oks,
                match_by_bbox=match_by_bbox,
                confidence_thr=self.prob_thr,
                padding=self.padding,
                ignore_near_bbox=ignore_border,
            )
            coco_eval.evaluate()
            coco_eval.accumulate()
            coco_eval.summarize()

            info_str.extend((f"{prefix}{k}{suffix}", v) for k, v in zip(coco_eval.stats_names, coco_eval.stats))
        return info_str

    def _do_python_variables_eval(self, gt_anns: Dict, dts: Dict[int, list]) -> list:
        """Visibility / in-image probability classification diagnostics;
        learns ``prob_thr`` consumed by the Ex-OKS grid."""
        gt_dict = {}
        for _, g in (gt_anns.items() if isinstance(gt_anns, dict) else enumerate(gt_anns)):
            kpts = np.array(g["keypoints"])
            if np.allclose(kpts, 0):
                continue
            gt_dict[(g["image_id"], g["id"])] = g
        dt_dict = {}
        for _, img_d in dts.items():
            for d in img_d:
                if not np.isscalar(d["id"]) and np.size(d["id"]) != 1:
                    # bottomup predictions carry the image's ann-id LIST, not
                    # a per-instance ann id — the 1:1 pred->GT-ann mapping
                    # these diagnostics need only exists in topdown GT-bbox
                    # mode, so skip them cleanly
                    return []
                dt_dict[(d["img_id"], int(np.asarray(d["id"]).reshape(())))] = d

        gt_vis, dt_vis, dt_probs, dt_scores = [], [], [], []
        for key, g in gt_dict.items():
            if key not in dt_dict:
                continue
            d = dt_dict[key]
            # recompute out-of-image visibility from the min padding needed to
            # contain each keypoint (reference coco_metric.py:866-878): points
            # outside the padded box are v=3, annotated-as-out points that are
            # actually inside become v=1
            gk = np.array(g["keypoints"], dtype=np.float64).reshape(-1, 3)
            gtv = gk[:, 2].copy()
            min_padding = find_min_padding_exact(np.array(g["bbox"], dtype=np.float64).flatten(), gk)
            kpts_out = min_padding > self.padding
            gtv[(gtv > 2) & (~kpts_out)] = 1
            gtv[kpts_out] = 3
            gt_vis.append(gtv)
            dt_vis.append(np.asarray(d["keypoints_visible"]).reshape(-1))
            dt_probs.append(np.asarray(d["keypoint_probs"]).reshape(-1))
            dt_scores.append(np.asarray(d["keypoint_scores"]).reshape(-1))
        if not gt_vis:
            return []

        gt_vis = np.concatenate(gt_vis).astype(np.float32)
        dt_vis = np.concatenate(dt_vis).astype(np.float32)
        dt_probs = np.concatenate(dt_probs).astype(np.float32)
        dt_scores = np.concatenate(dt_scores).astype(np.float32)

        # in-image probability target: v in {1,2} -> 1, v==3 -> 0, v==0 -> n/a
        gt_probs = gt_vis.copy()
        gt_probs[gt_probs == 0] = np.nan
        gt_probs[(gt_probs == 1) | (gt_probs == 2)] = 1
        gt_probs[gt_probs == 3] = 0

        # visibility target: v==1 -> 0 (occluded), v==2 -> 1, else n/a
        gt_v = gt_vis.copy()
        gt_v[gt_v == 0] = np.nan
        gt_v[gt_v == 1] = 0
        gt_v[gt_v == 2] = 1
        gt_v[gt_v == 3] = np.nan

        info_str = []
        vis_acc, vis_thr = self._do_classification_eval(gt_v, dt_vis, force_balance=True)
        info_str.extend([("vis_acc", float(vis_acc)), ("vis_thr", float(vis_thr))])

        unique_gt_probs = np.unique(gt_probs[~np.isnan(gt_probs)])
        if len(unique_gt_probs) > 1:
            prob_acc, prob_thr = self._do_classification_eval(gt_probs, dt_probs)
            info_str.extend([("prob_acc", float(prob_acc)), ("prob_thr", float(prob_thr))])
            score_acc, score_thr = self._do_classification_eval(gt_probs, dt_scores)
            info_str.extend([("score_acc", float(score_acc)), ("score_thr", float(score_thr))])
            self.prob_thr = prob_thr if self.has_probability else score_thr
        return info_str

    def _do_classification_eval(self, gts, dts, force_balance: bool = False):
        mask = ~np.isnan(gts)
        gts = gts[mask].astype(bool)
        dts = dts[mask]
        if force_balance:
            pos_idx = np.where(gts)[0]
            neg_idx = np.where(~gts)[0]
            num = min(len(pos_idx), len(neg_idx))
            if num == 0:
                return -1, -1
            np.random.shuffle(pos_idx)
            np.random.shuffle(neg_idx)
            idx = np.concatenate([pos_idx[:num], neg_idx[:num]])
            gts, dts = gts[idx], dts[idx]

        thresholds = np.linspace(0, 1.00, 21, endpoint=True)
        preds = dts[:, None] > thresholds
        correct = preds == gts[:, None]
        acc = correct.sum(axis=0) / len(gts)
        best = int(np.argmax(acc))
        return acc[best], thresholds[best]

    @staticmethod
    def _sort_and_unique_bboxes(kpts: Dict[int, list], key: str = "id") -> Dict[int, list]:
        for img_id, instances in kpts.items():
            instances = sorted(instances, key=lambda x: x[key])
            deduped = [
                inst for i, inst in enumerate(instances) if i == 0 or inst[key] != instances[i - 1][key]
            ]
            kpts[img_id] = deduped
        return kpts
