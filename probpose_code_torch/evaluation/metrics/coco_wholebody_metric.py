"""CocoWholeBodyMetric: COCO-WholeBody AP over the body, foot, face and hand
keypoints and over all 133.

The port's own copy of ``probpose_code_tpu/evaluation/metrics/
wholebody_and_more.py:36-104`` (reference ``mmpose/evaluation/metrics/
coco_wholebody_metric.py``): ``CocoMetric``'s scoring and OKS NMS over the
133 sigmas, then each kept prediction split into COCO-WholeBody's five
keypoint fields and one COCOeval per part iouType on its slice of the
sigmas, and one over all of them. The stats are named ``body_AP`` ...
``righthand_OKS`` and, for the whole body, ``AP`` ... ``OKS``, under
``CocoMetric``'s prefix (``coco``), as the JAX metric names them. The
ProbPose visibility and probability diagnostics are body-17 specific and
not run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from probpose_code_torch.registry import METRICS

from ..cocoeval import COCOeval, WHOLEBODY_PARTS
from .coco_metric import CocoMetric

# the keypoints of each part, in the order of the 133
PART_SIZES = dict(body=17, foot=6, face=68, lefthand=21, righthand=21)


@METRICS.register_module()
class CocoWholeBodyMetric(CocoMetric):
    """COCO-WholeBody AP over the 5 keypoint groups and the full set."""

    def _do_python_variables_eval(self, gt_anns, dts) -> list:
        return []

    def results2json(self, keypoints: Dict[int, list]) -> List[dict]:
        """The kept instances in COCO-WholeBody's result format: each
        prediction's rows split into the five part fields (no box: the
        result loader derives it from the body keypoints)."""
        cuts = np.cumsum([0, *PART_SIZES.values()]) * 3
        cat_results = []
        for _, img_kpts in keypoints.items():
            if not img_kpts:
                continue
            _keypoints = np.array([ik["keypoints"] for ik in img_kpts]).reshape(-1, cuts[-1])
            for img_kpt, kpt in zip(img_kpts, _keypoints):
                res = {"image_id": int(img_kpt["img_id"]), "category_id": int(img_kpt["category_id"])}
                res.update({field: kpt[lo:hi].tolist() for field, lo, hi in zip(WHOLEBODY_PARTS, cuts, cuts[1:])})
                res["score"] = float(img_kpt["score"])
                cat_results.append(res)
        return cat_results

    def _do_python_keypoint_eval(self, results: List[dict]) -> list:
        coco_det = self.coco.loadRes(results)
        sigmas = np.asarray(self.dataset_meta["sigmas"])
        cuts = np.cumsum([0, *PART_SIZES.values()])
        parts = [(name, lo, hi) for name, lo, hi in zip(PART_SIZES, cuts, cuts[1:])] + [("wholebody", 0, cuts[-1])]
        info_str = []
        for name, lo, hi in parts:
            coco_eval = COCOeval(self.coco, coco_det, iouType=f"keypoints_{name}", sigmas=sigmas[lo:hi],
                                 use_area=self.use_area)
            coco_eval.evaluate()
            coco_eval.accumulate()
            coco_eval.summarize()
            info_str.extend((f"{name}_{k}" if name != "wholebody" else k, v)
                            for k, v in zip(coco_eval.stats_names, coco_eval.stats))
        return info_str
