"""The port's CocoMetric and MultiDatasetEvaluator against the JAX package's.

The samples are the golden tiny fixture's predictions
(``tests/golden/e2e_pipeline.npz``, 62 instances of ``e2e_coco.json``), made
as each package's PoseDataSamples. With the flagship's settings
(``extended=[False, True]``, ``score_thresh_type="prob"``, ``padding``,
``oks_nms``), the other scoring and NMS modes, and evaluation without an
annotation file, every key (``AP``, ``Ex_AP``, ``prob_thr``, ...) equals the
JAX metric's to 1e-9; the visibility accuracy subsamples with NumPy's global
generator, so both run from the same seed. A MultiDatasetEvaluator routes a
two-dataset batch as the JAX one does.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from chip_smoke import COCO_METRIC
import probpose_code_torch.evaluation  # noqa: F401  (registers the metric and evaluators)
from probpose_code_torch.datasets.metainfo import parse_pose_metainfo
from probpose_code_torch.registry import EVALUATORS, METRICS
from probpose_code_torch.structures.data_sample import InstanceData, PoseDataSample

GOLDEN = Path(__file__).parent / "golden"
ANN = GOLDEN / "e2e_coco.json"
FIELDS = dict(keypoint_scores="pred_keypoint_scores", keypoints_probs="pred_keypoint_probs",
              keypoints_visible="pred_keypoints_visible", keypoints_oks="pred_keypoint_scores",
              keypoints_error="pred_keypoint_errors")


def golden_samples(sample_cls, instance_cls, name_of=lambda img_id: "coco"):
    """The fixture's predictions as ``sample_cls`` samples."""
    data = np.load(GOLDEN / "e2e_pipeline.npz")
    anns = {a["id"]: a for a in json.loads(ANN.read_text())["annotations"]}
    images = {im["id"]: im for im in json.loads(ANN.read_text())["images"]}
    samples = []
    for row, ann_id in enumerate(data["pred_ids"]):
        ann = anns[int(ann_id)]
        im = images[ann["image_id"]]
        s = sample_cls()
        s.set_metainfo(dict(id=int(ann_id), img_id=ann["image_id"], category_id=1, raw_ann_info=dict(ann),
                            ori_shape=(im["height"], im["width"]), dataset_name=name_of(ann["image_id"])))
        pred = instance_cls()
        pred.set_field(data["pred_keypoints"][row][None], "keypoints")
        for field, key in FIELDS.items():
            pred.set_field(data[key][row][None], field)
        x, y, w, h = ann["bbox"]
        pred.set_field(np.array([[x, y, x + w, y + h]], np.float32), "bboxes")
        s.pred_instances = pred
        gt = instance_cls()
        gt.set_field(np.ones(1, np.float32), "bbox_scores")
        s.gt_instances = gt
        samples.append(s)
    return samples


def jax_samples(**kw):
    from probpose_code_tpu.structures import InstanceData as JaxInstanceData
    from probpose_code_tpu.structures import PoseDataSample as JaxPoseDataSample

    return golden_samples(JaxPoseDataSample, JaxInstanceData, **kw)


CASES = {
    "flagship": {},
    "keypoint_soft_nms": dict(score_mode="keypoint", nms_mode="soft_oks_nms"),
    "bbox_no_nms": dict(score_mode="bbox", nms_mode="none", score_thresh_type="score"),
    "bbox_rle": dict(score_mode="bbox_rle", extended=[True], match_by_bbox=[True]),
    "no_ann_file": dict(ann_file=None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_metric_equals_jax(case):
    import probpose_code_tpu.evaluation  # noqa: F401  (registers the JAX metric)
    from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_metainfo
    from probpose_code_tpu.registry import METRICS as JAX_METRICS

    cfg = {**COCO_METRIC, "ann_file": str(ANN), **CASES[case]}
    results = []
    for registry, meta, samples in ((METRICS, parse_pose_metainfo, golden_samples(PoseDataSample, InstanceData)),
                                    (JAX_METRICS, jax_metainfo, jax_samples())):
        metric = registry.build(cfg)
        metric.dataset_meta = meta({"dataset_name": "coco"})
        metric.process(None, samples)
        np.random.seed(0)
        results.append(metric.evaluate())
    ours, ref = results
    assert list(ours) == list(ref) and any(k.endswith("AP") for k in ours)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-9), k
    if case == "flagship":
        data = np.load(GOLDEN / "e2e_pipeline.npz")
        assert ours["coco/prob_thr"] == pytest.approx(float(data["prob_thr"]), abs=1e-9)
        assert ours["coco/AP"] == pytest.approx(data["stats"][0], abs=1e-9)
        assert ours["coco/Ex_AP"] == pytest.approx(data["Ex_stats"][0], abs=1e-9)


def test_multi_dataset_evaluator_routes_as_jax():
    import probpose_code_tpu.evaluation  # noqa: F401
    from probpose_code_tpu.datasets.metainfo import parse_pose_metainfo as jax_metainfo
    from probpose_code_tpu.registry import EVALUATORS as JAX_EVALUATORS

    cfg = dict(
        type="MultiDatasetEvaluator",
        metrics=[dict(COCO_METRIC, ann_file=str(ANN), prefix=p) for p in ("CropCOCO", "COCO")],
        datasets=[dict(type="CocoCropDataset"), dict(type="CocoDataset")],
    )

    def name_of(img_id):  # one instance stream for each sub-dataset, and one name no metric has
        return ("coco_crop", "coco", "other")[img_id % 3]

    results = []
    for registry, meta, samples in (
        (EVALUATORS, parse_pose_metainfo, golden_samples(PoseDataSample, InstanceData, name_of=name_of)),
        (JAX_EVALUATORS, jax_metainfo, jax_samples(name_of=name_of)),
    ):
        evaluator = registry.build(cfg)
        evaluator.dataset_meta = meta({"dataset_name": "coco"})
        assert evaluator.dataset_names == ["coco_crop", "coco"]
        for i in range(0, len(samples), 16):
            evaluator.process(samples[i:i + 16])
        np.random.seed(0)
        results.append(evaluator.evaluate())
    ours, ref = results
    assert list(ours) == list(ref) and {"CropCOCO/AP", "COCO/AP", "CropCOCO/Ex_AP", "COCO/Ex_AP"} <= set(ours)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-9), k
