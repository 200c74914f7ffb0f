"""PoseTrack18Metric: PoseTrack18's per-joint-group AP, and COCO AP.

The port's own copy of ``probpose_code_tpu/evaluation/metrics/
wholebody_and_more.py:PoseTrack18Metric`` (``:252-341``; reference
``mmpose/evaluation/metrics/posetrack18_metric.py``): ``CocoMetric``'s
scoring and OKS NMS, then

- where ``outfile_prefix`` is given, the kept predictions written under it
  as one submission json a video (the video keyed by ``os.path.dirname`` of
  the frame's ``file_name`` in the annotation file; the JAX metric, whose
  predictions carry no file name, writes every frame to ``video.json``) and
  the flat ``all.keypoints.json`` (the JAX metric writes them to a
  temporary directory otherwise and reads the flat file back; the port
  keeps the results in memory, as its ``CocoMetric`` does);
- the per-joint-group AP table (``Head AP`` ... ``Ankl AP``, ``AP``) of
  ``evaluation/functional/poseval.py:evaluate_ap`` over the ground-truth
  frames of the annotation file (each annotation with keypoints, its
  ``bbox_head`` and ``bbox``) and the flat results (each joint's score its
  keypoint's times the instance's);
- the COCO AP of the flat results, its stats prefixed ``coco_``.

The JAX metric reads the frames from ``self.coco.imgToAnns``, which its COCO
index does not have (it names it ``img_to_anns``): its table has no ground
truth and every AP is NaN (``tests/test_torch_posetrack.py``). The port reads
``img_to_anns``.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from probpose_code_torch.registry import METRICS

from ..functional.poseval import evaluate_ap
from .coco_metric import CocoMetric


@METRICS.register_module()
class PoseTrack18Metric(CocoMetric):
    def __init__(self, ann_file: Optional[str] = None, score_mode: str = "bbox_keypoint",
                 keypoint_score_thr: float = 0.2, nms_mode: str = "oks_nms", nms_thr: float = 0.9,
                 outfile_prefix: Optional[str] = None, prefix: Optional[str] = None):
        super().__init__(ann_file=ann_file, score_mode=score_mode, keypoint_score_thr=keypoint_score_thr,
                         nms_mode=nms_mode, nms_thr=nms_thr, prefix=prefix)
        self.outfile_prefix = outfile_prefix

    def write_submission(self, results: List[dict], out_dir: str) -> None:
        """One json a video in PoseTrack18's submission format (a frame's
        video the directory of its file name), and the flat results as
        ``all.keypoints.json``."""
        by_video = defaultdict(lambda: dict(images=[], annotations=[]))
        seen = set()
        for res in results:
            img_id = res["image_id"]
            file_name = self.coco.imgs.get(img_id, {}).get("file_name", f"{img_id}.jpg")
            video = by_video[os.path.dirname(file_name) or "video"]
            if img_id not in seen:
                seen.add(img_id)
                video["images"].append(dict(id=img_id, file_name=file_name))
            kpt = np.asarray(res["keypoints"]).reshape(-1, 3)
            video["annotations"].append(dict(image_id=img_id, keypoints=kpt.reshape(-1).tolist(),
                                             scores=kpt[:, 2].tolist(), score=res["score"], track_id=0))
        os.makedirs(out_dir, exist_ok=True)
        for video, data in by_video.items():
            data["categories"] = [dict(id=1, name="person")]
            with open(os.path.join(out_dir, f"{video.replace('/', '_')}.json"), "w") as f:
                json.dump(data, f)
        with open(os.path.join(out_dir, "all.keypoints.json"), "w") as f:
            json.dump(results, f, sort_keys=True, indent=4)

    def _do_python_keypoint_eval(self, results: List[dict]) -> list:
        if self.outfile_prefix:
            self.write_submission(results, self.outfile_prefix)
        gt_frames: Dict = {
            img_id: [dict(keypoints=a["keypoints"], bbox_head=a.get("bbox_head"), bbox=a.get("bbox"))
                     for a in anns if a.get("keypoints")]
            for img_id, anns in self.coco.img_to_anns.items()
        }
        pred_frames = defaultdict(list)
        for d in results:
            kp = np.asarray(d["keypoints"], np.float64).reshape(-1, 3)
            pred_frames[d["image_id"]].append(
                dict(keypoints=d["keypoints"], scores=(kp[:, 2] * float(d.get("score", 1.0))).tolist()))
        info = evaluate_ap(gt_frames, dict(pred_frames))
        info.extend((f"coco_{k}", v) for k, v in super()._do_python_keypoint_eval(results))
        return info
